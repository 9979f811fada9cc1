from .id_loss import IRSE50, id_loss, id_similarity, load_irse50_state, random_irse50
from .image import area_downsample, l1_loss, l2_loss, sobel_loss, ssim
from .lpips import VGG16LPIPS, lpips_loss

__all__ = ["area_downsample", "l1_loss", "l2_loss", "sobel_loss", "ssim", "VGG16LPIPS",
           "lpips_loss", "IRSE50", "id_loss", "id_similarity", "load_irse50_state",
           "random_irse50"]
