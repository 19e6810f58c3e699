from repro_torch.data.pipeline import DataConfig, TokenPipeline, LatentPipeline

__all__ = ["DataConfig", "TokenPipeline", "LatentPipeline"]
