from repro_torch.configs.base import (  # noqa: F401
    PAPER_MODELS, ModelConfig, get_config, reduced, register,
)
