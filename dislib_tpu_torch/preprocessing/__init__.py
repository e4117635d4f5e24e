"""Feature scalers (counterpart of ``dislib_tpu/preprocessing``)."""

from dislib_tpu_torch.preprocessing.scalers import StandardScaler, MinMaxScaler

__all__ = ["StandardScaler", "MinMaxScaler"]
