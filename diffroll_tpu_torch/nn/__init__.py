from .denoiser import DiffRollNet
from .embedding import DiffusionEmbedding
from .resblock import ResidualBlock

__all__ = ["DiffRollNet", "DiffusionEmbedding", "ResidualBlock"]
