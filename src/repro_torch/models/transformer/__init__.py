from repro_torch.models.transformer.config import MoEConfig, TransformerConfig
from repro_torch.models.transformer import model

__all__ = ["TransformerConfig", "MoEConfig", "model"]
