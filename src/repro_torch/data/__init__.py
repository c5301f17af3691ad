from repro_torch.data.tokens import synthetic_lm_batches

__all__ = ["synthetic_lm_batches"]
