"""Host-side utilities: encoders, normalizers, metrics, profiling."""

from simulate_2048_tpu_torch.utils.encoding import encode, encode_flatten, normalize_reward

__all__ = ["encode", "encode_flatten", "normalize_reward"]
