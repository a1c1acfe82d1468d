from .denoiser import DiffRollNet, DiffRollNet2D
from .embedding import DiffusionEmbedding
from .resblock import ResidualBlock, ResidualBlock2D
from .unet import SpecUnetNet, UnetNet

__all__ = ["DiffRollNet", "DiffRollNet2D", "DiffusionEmbedding", "ResidualBlock",
           "ResidualBlock2D", "SpecUnetNet", "UnetNet"]
