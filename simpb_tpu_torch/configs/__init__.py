from .base import (  # noqa: F401
    CLASS_NAMES,
    HeadConfig,
    ModelConfig,
    TrainConfig,
    simpb_r50_704x256,
    simpb_r50_704x256_fast,
    simpb_tiny,
)
