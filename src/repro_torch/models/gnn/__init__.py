from repro_torch.models.gnn.config import GNNConfig
from repro_torch.models.gnn import models

__all__ = ["GNNConfig", "models"]
