from .config import (SAMPLE_RATES, DataConfig, ExperimentConfig, ModelConfig,
                     get_config)

__all__ = ["SAMPLE_RATES", "DataConfig", "ExperimentConfig", "ModelConfig",
           "get_config"]
