"""GAN and decoder metrics — port of the JAX package's metrics/: FID, KID,
precision / recall, IS, PPL and the equivariance metrics, the InceptionV3
feature extractor and the registry with its sample streams."""
from .feature_stats import FeatureStats
from .frechet import fid_from_stats, frechet_distance
from .inception import InceptionV3, load_inception
from .kernel import kid_from_features
from .metric_main import calc_metric, list_metrics, register_metric
from .precision_recall import precision_recall

__all__ = ["FeatureStats", "InceptionV3", "calc_metric", "fid_from_stats", "frechet_distance",
           "kid_from_features", "list_metrics", "load_inception", "precision_recall",
           "register_metric"]
