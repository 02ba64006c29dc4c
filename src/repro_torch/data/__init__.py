from .pipeline import DataPipeline, PipelineConfig
