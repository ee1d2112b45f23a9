"""The paper's own workload: YoutubeDNN on MovieLens (filtering + ranking).

Model/ET dims from Table I; see `repro_torch/models/recsys.py`.
"""
from repro_torch.models.recsys import (
    YoutubeDNNConfig,
    default_youtubednn_config,
)


def model_config() -> YoutubeDNNConfig:
    return default_youtubednn_config()
