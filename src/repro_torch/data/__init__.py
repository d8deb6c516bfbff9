"""The data pipeline of the port (counterpart of ``src/repro/data/``)."""

from repro_torch.data.pipeline import DataConfig, Pipeline, PipelineState, write_token_file

__all__ = ["DataConfig", "PipelineState", "Pipeline", "write_token_file"]
