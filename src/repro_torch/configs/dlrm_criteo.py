"""The paper's own workload: Facebook DLRM ranking on Criteo Kaggle.

Bottom MLP 256-128-32, top MLP 256-64-1, 26 ETs x 28000 rows (Table I).
"""
from repro_torch.models.recsys import DLRMConfig


def model_config() -> DLRMConfig:
    return DLRMConfig()
