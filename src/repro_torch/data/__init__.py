"""Data feeds of the port: the LM token pipeline and the versioned
postings source."""

from .pipeline import (DataConfig, PipelineCursor, PostingsSource,
                       ShardedTokenPipeline, SyntheticLMDataset)

__all__ = [
    "DataConfig",
    "ShardedTokenPipeline",
    "SyntheticLMDataset",
    "PipelineCursor",
    "PostingsSource",
]
