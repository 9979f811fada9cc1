from .bias_act import activation_funcs, bias_act
from .filtered_lrelu import filtered_lrelu
from .grid_sample import grid_sample_2d, grid_sample_3d
from .knn import mean_sq_dist_to_knn
from .modulated_conv import conv2d_resample, modulated_conv2d
from .resize import resize_bilinear
from .upfirdn2d import downsample2d, filter2d, setup_filter, upfirdn2d, upsample2d

__all__ = ["activation_funcs", "bias_act", "conv2d_resample", "downsample2d", "filter2d",
           "filtered_lrelu", "grid_sample_2d", "grid_sample_3d", "mean_sq_dist_to_knn",
           "modulated_conv2d", "resize_bilinear", "setup_filter", "upfirdn2d", "upsample2d"]
