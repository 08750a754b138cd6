from cse_tpu_torch.models.sepformer import (
    Sepformer,
    SepformerConfig,
    TransformerStack,
    sinusoidal_pe,
)

__all__ = ["Sepformer", "SepformerConfig", "TransformerStack", "sinusoidal_pe"]
