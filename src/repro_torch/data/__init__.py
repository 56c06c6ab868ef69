"""Data feeds of the port: the versioned postings source."""

from .pipeline import PostingsSource

__all__ = ["PostingsSource"]
