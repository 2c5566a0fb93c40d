from repro_torch.data.pipeline import CodedShardReader, SyntheticTokens

__all__ = ["CodedShardReader", "SyntheticTokens"]
