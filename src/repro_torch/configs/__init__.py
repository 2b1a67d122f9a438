"""Model and topology configs of the port (torch dtypes): the reference's 10
assigned archs, the paper's three GPT-2 sizes and nano."""

from repro_torch.configs.base import (
    ARCH_IDS,
    INPUT_SHAPES,
    PAPER_ARCH_IDS,
    InputShape,
    ModelConfig,
    TopologyConfig,
    arch_supports_shape,
    load_arch,
)
