from repro_torch.models.model import Model, build_model, cache_struct

__all__ = ["Model", "build_model", "cache_struct"]
