"""Scene readers of the classic 3DGS pipeline and the GAN trainer's image
datasets."""
from .dataset import ImageFolderDataset, InfiniteSampler, MaskLabeledDataset, batch_iterator

__all__ = ["ImageFolderDataset", "InfiniteSampler", "MaskLabeledDataset", "batch_iterator"]
