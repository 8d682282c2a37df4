from .pipeline import DataConfig, FileTokens, Pipeline, SyntheticLM, \
    for_model

__all__ = ["DataConfig", "FileTokens", "Pipeline", "SyntheticLM",
           "for_model"]
