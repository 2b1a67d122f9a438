"""Model and topology configs of the port (torch dtypes)."""

from repro_torch.configs.base import ModelConfig, TopologyConfig, load_arch
