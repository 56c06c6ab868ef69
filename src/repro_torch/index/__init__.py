from .corpus import SyntheticCorpus, zipf_corpus
from .builder import InvertedIndex, build_index

__all__ = ["SyntheticCorpus", "zipf_corpus", "InvertedIndex", "build_index"]
