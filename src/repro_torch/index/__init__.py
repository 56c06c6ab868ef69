from .corpus import SyntheticCorpus, zipf_corpus, pack_documents
from .builder import InvertedIndex, build_index
from .hybrid import HybridQueryEngine

__all__ = [
    "SyntheticCorpus",
    "zipf_corpus",
    "pack_documents",
    "InvertedIndex",
    "build_index",
    "HybridQueryEngine",
]
