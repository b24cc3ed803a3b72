from repro_torch.models.recsys.config import AutoIntConfig
from repro_torch.models.recsys import autoint, embedding

__all__ = ["AutoIntConfig", "autoint", "embedding"]
