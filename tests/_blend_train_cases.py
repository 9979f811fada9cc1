"""Tiles of pairs that put the training blend's stop (T < 1e-4) where the
K4 scan has to decide, shared by the CPU model test and the card-only
tests. With the 32-pair entry chunks:

- "last": 31 pairs of alpha 0.234 leave T = 2.58e-4, the 32nd (alpha 0.9)
  stops every pixel at pair 31, the last of chunk 0;
- "first": 128 pairs of alpha 0.06437 leave T = 2.00e-4, pair 128 (alpha
  0.9) stops every pixel at the first pair of chunk 4;
- "margin": 32 pairs of alpha 0.2501044 leave T P_c = 1.000058e-4, inside
  the scan's margin (1e-4 to 1.0001e-4): the chunk is replayed and stops
  no pixel; pair 32 stops them all;
- "underflow": 40 pairs of opacity 0.98 and conic 0.02 centred on pixel
  (3, 3): the product over chunk 0 underflows to 0 near that pixel, which
  stops at its third pair, while the tile's far corner stays open;
- "straddle": 32 pairs of alpha 0.0656147 (T = 0.114), then 32 of seeded
  alphas whose product, times that T, rounds to 1.00000005e-4 while the
  sequential fold from it ends at 9.999998e-5: the fold stops at the
  chunk's last pair, a scan without its margin would not; nothing follows.

All but "underflow" have a zero conic: alpha is then the opacity itself at
every pixel (exp(0) = 1), so T and the products are the same IEEE f32
roundings everywhere, and the stops fall where the construction says.
Each tile but "straddle" ends with a few pairs of random colour past the
stop.
"""
import numpy as np


def _pairs(n, ox, oy, cx, cy, conic, op, rng):
    cols = np.zeros((9, n))
    cols[0], cols[1] = ox + cx, oy + cy
    cols[2] = cols[4] = conic
    cols[5] = op
    cols[6:9] = rng.uniform(0.0, 1.2, (3, n))
    return cols


def boundary_tiles(origins, rng):
    """-> {name: (9, n) float32 pair fields} of the five tiles above, at the
    tile origins (ox, oy) given in the order last, first, margin,
    underflow, straddle."""
    (la, lb), (fa, fb), (ma, mb), (ua, ub), (sa, sb) = origins
    tiles = {
        "last": [_pairs(31, la, lb, 7.5, 7.5, 0.0, 0.234, rng),
                 _pairs(1, la, lb, 7.5, 7.5, 0.0, 0.9, rng),
                 _pairs(20, la, lb, 7.5, 7.5, 0.0, 0.5, rng)],
        "first": [_pairs(128, fa, fb, 7.5, 7.5, 0.0, 0.06437, rng),
                  _pairs(1, fa, fb, 7.5, 7.5, 0.0, 0.9, rng),
                  _pairs(30, fa, fb, 7.5, 7.5, 0.0, 0.5, rng)],
        "margin": [_pairs(32, ma, mb, 7.5, 7.5, 0.0, 0.2501044, rng),
                   _pairs(1, ma, mb, 7.5, 7.5, 0.0, 0.9, rng),
                   _pairs(20, ma, mb, 7.5, 7.5, 0.0, 0.5, rng)],
        "underflow": [_pairs(40, ua, ub, 3.0, 3.0, 0.02, 0.98, rng),
                      _pairs(10, ua, ub, 7.5, 7.5, 0.0, 0.5, rng)],
        "straddle": [_pairs(32, sa, sb, 7.5, 7.5, 0.0, 0.06561470776796341, rng),
                     _pairs(32, sa, sb, 7.5, 7.5, 0.0,
                            np.random.RandomState(6).uniform(0.05, 0.3, 32), rng)],
    }
    return {k: np.concatenate(v, axis=1).astype(np.float32) for k, v in tiles.items()}
