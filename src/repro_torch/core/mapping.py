"""Embedding-table -> (banks, mats, CMAs) mapping — iMARS Table I.

A copy of `repro/core/mapping.py` (plain Python; only the imports
changed).

Geometry (Sec. III-B / IV): CMAs are 256x256; each int8 32-dim embedding row
is 256 bits = one CMA row; the ItET additionally stores a 256-bit LSH
signature per entry ("2 CMAs to store a single entry"). One sparse feature
maps to one bank; CMAs per ET = width_cmas * ceil(rows/256); mats per ET =
ceil(cmas / C) with C = 32.

The MovieLens feature set is reconstructed from Table I's totals (the paper
does not list the features): 5 filtering UIETs (user_id 6040, gender 3,
age 7, occupation 21, zip bucket 250), +1 ranking-only UIET (genre 18), the
ItET (3000 items, embedding+signature), and the CTR buffer (1 CMA in its own
mat, co-located in the ItET bank). This reproduces exactly 7 banks / 8 mats /
54 CMAs; Criteo's 26 x 28000-row ETs reproduce 26 / 104 / 2860. Both are
asserted in tests/test_mapping_cost_model.py, and the port's copy is
held equal to the reference's in tests/test_torch_serving.py.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.utils import cdiv

CMA_ROWS = 256
CMA_COLS = 256
CMAS_PER_MAT = 32  # C
MATS_PER_BANK = 4  # M (dimensioned for Criteo, Sec. IV)
INTRABANK_FANIN = 4


@dataclasses.dataclass(frozen=True)
class ETSpec:
    name: str
    n_rows: int
    dim: int = 32
    bits: int = 8
    lsh_bits: int = 0  # ItET stores signatures alongside embeddings
    stages: tuple = ("filtering",)  # which stages use it
    kind: str = "uiet"  # "uiet" | "itet" | "ctr"

    @property
    def row_bits(self) -> int:
        return self.dim * self.bits + self.lsh_bits

    @property
    def width_cmas(self) -> int:
        return cdiv(self.row_bits, CMA_COLS)

    @property
    def n_cmas(self) -> int:
        return self.width_cmas * cdiv(self.n_rows, CMA_ROWS)

    @property
    def n_mats(self) -> int:
        return cdiv(self.n_cmas, CMAS_PER_MAT)


@dataclasses.dataclass(frozen=True)
class MappingResult:
    banks: int
    mats: int
    cmas: int
    per_et: tuple


def map_recsys(ets: Sequence[ETSpec]) -> MappingResult:
    """One bank per sparse feature; CTR buffers share the ItET bank."""
    banks = sum(1 for et in ets if et.kind != "ctr")
    mats = sum(et.n_mats for et in ets)
    cmas = sum(et.n_cmas for et in ets)
    per_et = tuple(
        (et.name, et.n_cmas, et.n_mats, et.kind) for et in ets
    )
    return MappingResult(banks=banks, mats=mats, cmas=cmas, per_et=per_et)


# --- MovieLens 1M + YoutubeDNN (Table I, left) -----------------------------
MOVIELENS_ETS: tuple[ETSpec, ...] = (
    ETSpec("user_id", 6040, stages=("filtering", "ranking")),
    ETSpec("gender", 3, stages=("filtering", "ranking")),
    ETSpec("age", 7, stages=("filtering", "ranking")),
    ETSpec("occupation", 21, stages=("filtering", "ranking")),
    ETSpec("zip_bucket", 250, stages=("filtering", "ranking")),
    ETSpec("genre", 18, stages=("ranking",)),
    ETSpec("item", 3000, lsh_bits=256, stages=("filtering", "ranking"),
           kind="itet"),
    ETSpec("ctr_buffer", 128, stages=("ranking",), kind="ctr"),
)

# --- Criteo Kaggle + DLRM (Table I, right) ---------------------------------
CRITEO_ETS: tuple[ETSpec, ...] = tuple(
    ETSpec(f"cat_{i:02d}", 28000, stages=("ranking",)) for i in range(26)
)


def movielens_mapping() -> MappingResult:
    return map_recsys(MOVIELENS_ETS)


def criteo_mapping() -> MappingResult:
    return map_recsys(CRITEO_ETS)
