from .corpus import SyntheticCorpus, zipf_corpus

__all__ = ["SyntheticCorpus", "zipf_corpus"]
