"""Parameter counts of the port's models.

``param_count`` counts the port's flat layout, the leaves of the
reference's ``init_params`` tree, over every dtype group; it raises
``ValueError`` for a family or block kind that the reference does not
build either.  The reference's
abstract specs, sharding specs and ``active_param_count`` serve its dry-run
and are not ported (ROADMAP.md).
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import layout


def param_count(cfg: ModelConfig) -> int:
    return layout(cfg).numel
