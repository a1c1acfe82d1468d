from .denoiser import DiffRollNet, DiffRollNet2D
from .diffwave import DiffWaveNet
from .embedding import DiffusionEmbedding
from .resblock import ResidualBlock, ResidualBlock2D
from .unet import SpecUnetNet, UnetNet

__all__ = ["DiffRollNet", "DiffRollNet2D", "DiffWaveNet", "DiffusionEmbedding", "ResidualBlock",
           "ResidualBlock2D", "SpecUnetNet", "UnetNet"]
