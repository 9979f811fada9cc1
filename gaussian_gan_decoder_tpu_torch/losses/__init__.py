from .image import area_downsample, l1_loss, l2_loss, sobel_loss, ssim
from .lpips import VGG16LPIPS, lpips_loss

__all__ = ["area_downsample", "l1_loss", "l2_loss", "sobel_loss", "ssim", "VGG16LPIPS",
           "lpips_loss"]
