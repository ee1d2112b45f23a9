"""iMARS hardware cost model — reproduces Tables II & III and the end-to-end
claims (16.8x/713x MovieLens, 13.2x/57.8x Criteo) from array-level FoMs.

A copy of `repro/core/cost_model.py`: the same expressions in the same
order, so every float equals the reference's. Its outputs are the paper's
analytic FeFET model, and `GPU_PAPER` / `GPU_IMPLIED` are the paper's own
GPU baseline: none of them is a measurement of the card the port runs on.

Structure (everything per one query input, like the paper):

  ET lookup stage (Table III):
    latency = H*(t_read + t_add)                 # worst case: H pooled lookups
              + t_intramat + rounds*t_intrabank  # adder-tree hierarchy
              + (n_ets + 1) * t_rsc              # serialized RSC transfers
    energy  = sum_lookups*(e_read + e_add + e_write)
              + per-ET adder energies
              + n_shots * e_shot(banks)          # bus/communication energy

  NNS (Sec. IV-C2): one parallel TCAM search over the signature CMAs.
  Crossbar DNN: ceil-tiled 256x128 MVMs, serialized per layer over the RSC.

Calibration (the paper gives Table II FoMs and Table I mapping but not the
communication constants or the pooling multiplicity; we fit FOUR global
constants against the SIX Table III observations and report residuals):

    t_rsc   = 6.3963 ns / 256-bit RSC transfer   (exact on Criteo latency)
    e_shot(b) = 21901 + 1164.9 * b  pJ / shot    (bus energy grows with bank
                                                  count = wire length; exact on
                                                  ML-filter + Criteo energy)
    H_ml    = 12 pooled lookups / query          (MovieLens history pooling)
    e_prio  = 5191 pJ                            (NNS priority encode + drive)

  Residuals on the held-out entries: ML-filter latency +2.6%, ML-rank latency
  +0.4%, ML-rank energy +0.3% — see tests/test_mapping_cost_model.py.

End-to-end (Sec. IV-C3): the iMARS side is structural (components above +
one calibrated per-candidate controller overhead t_ctrl = 447.7 ns); the GPU
side uses the paper's measured Table III entries plus *paper-implied* GPU DNN
costs derived from the published end-to-end ratios (the paper never lists GPU
DNN times separately). Both are labeled in the benchmark output.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core import mapping as mp
from repro_torch.utils import cdiv

# ---------------------------------------------------------------------------
# Table II — array-level figures of merit (energy pJ, latency ns)
# ---------------------------------------------------------------------------
ARRAY_FOM = {
    "cma_write": (49.1, 10.0),
    "cma_read": (3.2, 0.3),
    "cma_add": (108.0, 8.1),
    "cma_search": (13.8, 0.2),
    "intramat_add": (137.0, 14.7),
    "intrabank_add": (956.0, 44.2),
    "xbar_matmul": (13.8, 225.0),  # 256x128 crossbar
}

XBAR_IN, XBAR_OUT = 256, 128


@dataclasses.dataclass(frozen=True)
class Calibration:
    t_rsc_ns: float = 6.3963  # per 256-bit RSC transfer
    e_shot_base_pj: float = 21901.0  # bus energy intercept
    e_shot_per_bank_pj: float = 1164.9  # bus energy slope vs bank count
    history_lookups: int = 12  # MovieLens pooled lookups / query
    e_priority_pj: float = 5191.4  # NNS priority encoder + SL drivers
    t_ctrl_ns: float = 447.68  # per-candidate controller overhead


CAL = Calibration()


def e_shot(banks: int, cal: Calibration = CAL) -> float:
    return cal.e_shot_base_pj + cal.e_shot_per_bank_pj * banks


@dataclasses.dataclass(frozen=True)
class OpCost:
    latency_ns: float
    energy_pj: float

    @property
    def latency_us(self):
        return self.latency_ns / 1e3

    @property
    def energy_uj(self):
        return self.energy_pj / 1e6

    def __add__(self, other: "OpCost") -> "OpCost":
        return OpCost(self.latency_ns + other.latency_ns,
                      self.energy_pj + other.energy_pj)

    def scale(self, k: float) -> "OpCost":
        return OpCost(self.latency_ns * k, self.energy_pj * k)


ZERO = OpCost(0.0, 0.0)


# ---------------------------------------------------------------------------
# ET lookup + pooling (Table III rows)
# ---------------------------------------------------------------------------
def et_lookup_stage_cost(
    ets: Sequence[mp.ETSpec],
    stage: str,
    fabric_banks: int,
    pooled_lookups: int,
    cal: Calibration = CAL,
) -> OpCost:
    """Cost of all ET lookups + pooling for one input in one stage.

    Banks operate in parallel: latency is the dominant (pooled) ET chain plus
    the adder hierarchy plus serialized RSC transfers (one per ET used, +1 to
    deliver the result). Energy sums every lookup and every adder/bus shot.
    """
    used = [e for e in ets if stage in e.stages and e.kind != "ctr"]
    n_ets = len(used)
    e_read, t_read = ARRAY_FOM["cma_read"]
    e_add, t_add = ARRAY_FOM["cma_add"]
    e_write, _ = ARRAY_FOM["cma_write"]
    e_im, t_im = ARRAY_FOM["intramat_add"]
    e_ib, t_ib = ARRAY_FOM["intrabank_add"]

    # --- latency: dominant ET = the pooled one (worst case: same array) ---
    rounds = 1  # intra-bank adder tree rounds for the dominant ET
    latency = (
        pooled_lookups * (t_read + t_add)
        + t_im
        + rounds * t_ib
        + (n_ets + 1) * cal.t_rsc_ns
    )

    # --- energy: every lookup, every ET's adders, every bus shot ---
    total_lookups = pooled_lookups + (n_ets - 1)  # 1 lookup per non-pooled ET
    e_ops = total_lookups * (e_read + e_add + e_write)
    e_adders = 0.0
    n_ibc_shots = 0
    for et in used:
        mats = et.n_mats
        e_adders += e_im * mats + e_ib * max(1, cdiv(max(mats - 1, 1), 3))
        n_ibc_shots += mats
    n_shots = (n_ets + 1) + n_ibc_shots
    energy = e_ops + e_adders + n_shots * e_shot(fabric_banks, cal)
    return OpCost(latency, energy)


def nns_cost(sig_cmas: int, cal: Calibration = CAL) -> OpCost:
    """TCAM threshold search: all signature CMAs searched in parallel."""
    e_s, t_s = ARRAY_FOM["cma_search"]
    return OpCost(t_s, e_s * sig_cmas + cal.e_priority_pj)


def ctr_topk_cost(cal: Calibration = CAL) -> OpCost:
    """CTR-buffer threshold match + one RSC transfer."""
    e_s, t_s = ARRAY_FOM["cma_search"]
    return OpCost(t_s + cal.t_rsc_ns, e_s + e_shot(7, cal))


def crossbar_mlp_cost(dims: Sequence[int], fabric_banks: int,
                      cal: Calibration = CAL) -> OpCost:
    """Serialized crossbar MLP: per layer one tiled MVM + one RSC transfer."""
    e_x, t_x = ARRAY_FOM["xbar_matmul"]
    latency = energy = 0.0
    for din, dout in zip(dims[:-1], dims[1:]):
        tiles = cdiv(din, XBAR_IN) * cdiv(dout, XBAR_OUT)
        latency += t_x + cal.t_rsc_ns
        energy += tiles * e_x + e_shot(fabric_banks, cal)
    return OpCost(latency, energy)


# ---------------------------------------------------------------------------
# Paper-measured GPU constants (Table III + Sec. IV-C2) — NOT model outputs
# ---------------------------------------------------------------------------
GPU_PAPER = {
    # stage: (latency_us, energy_uj)
    "ml_filter_et": (9.27, 203.97),
    "ml_rank_et": (9.60, 211.26),
    "criteo_rank_et": (14.97, 329.34),
    "ml_nns_cosine": (13.6, 340.0),  # 0.34 mJ
    "ml_nns_lsh": (6.97, 150.0),  # 0.15 mJ
}

# Paper-implied GPU DNN costs (derived from the published end-to-end ratios;
# the paper does not list them separately — see module docstring).
GPU_IMPLIED = {
    "ml_dnn_filter": (16.536, 455.9),  # us, uJ
    "ml_dnn_rank_per_cand": (5.0, 130.0),
    "criteo_dnn": (12.434, 86.43),
}

PAPER_TABLE3_IMARS = {
    # stage: (latency_us, energy_uj) as published
    "ml_filter": (0.21, 0.40),
    "ml_rank": (0.21, 0.46),
    "criteo_rank": (0.24, 6.88),
}

PAPER_END_TO_END = {
    "ml_qps_gpu": 1311.0,
    "ml_qps_imars": 22025.0,
    "ml_latency_speedup": 16.8,
    "ml_energy_reduction": 713.0,
    "criteo_latency_speedup": 13.2,
    "criteo_energy_reduction": 57.8,
    "nns_latency_speedup": 3.8e4,
    "nns_energy_reduction": 2.8e4,
    "dnn_latency_speedup": 2.69,
}

N_CANDIDATES = 50  # filtering-stage output (paper: O(100) candidates)

# DNN stacks (Table I). MovieLens filtering tower input: 5 UIET embeddings
# (32 each) + pooled history (32) = 192; ranking input: user embedding (32) +
# item (32) + ranking UIETs -> 128 (Table I: "128-1").
ML_FILTER_DNN = (192, 128, 64, 32)
ML_RANK_DNN = (128, 1)
CRITEO_BOTTOM_DNN = (13, 256, 128, 32)
CRITEO_TOP_DNN = (383, 256, 64, 1)  # 27*26/2 pairwise dots + dense 32


# ---------------------------------------------------------------------------
# Table III model outputs
# ---------------------------------------------------------------------------
def movielens_et_costs(cal: Calibration = CAL) -> dict[str, OpCost]:
    ets = mp.MOVIELENS_ETS
    banks = mp.movielens_mapping().banks
    return {
        "ml_filter": et_lookup_stage_cost(
            ets, "filtering", banks, cal.history_lookups, cal),
        "ml_rank": et_lookup_stage_cost(
            ets, "ranking", banks, cal.history_lookups, cal),
    }


def criteo_et_costs(cal: Calibration = CAL) -> dict[str, OpCost]:
    ets = mp.CRITEO_ETS
    banks = mp.criteo_mapping().banks
    return {
        "criteo_rank": et_lookup_stage_cost(ets, "ranking", banks, 1, cal),
    }


def table3_model(cal: Calibration = CAL) -> dict[str, dict]:
    """Model vs paper for every Table III iMARS entry."""
    model = {**movielens_et_costs(cal), **criteo_et_costs(cal)}
    out = {}
    for stage, cost in model.items():
        p_lat, p_en = PAPER_TABLE3_IMARS[stage]
        g_lat, g_en = GPU_PAPER[stage + "_et"]
        out[stage] = {
            "model_latency_us": cost.latency_us,
            "paper_latency_us": p_lat,
            "latency_rel_err": cost.latency_us / p_lat - 1.0,
            "model_energy_uj": cost.energy_uj,
            "paper_energy_uj": p_en,
            "energy_rel_err": cost.energy_uj / p_en - 1.0,
            "speedup_vs_gpu": g_lat / cost.latency_us,
            "energy_reduction_vs_gpu": g_en / cost.energy_uj,
        }
    return out


def ml_nns_model(cal: Calibration = CAL) -> dict:
    sig_cmas = cdiv(3000, mp.CMA_ROWS)  # signature columns of the ItET
    cost = nns_cost(sig_cmas, cal)
    g_lat, g_en = GPU_PAPER["ml_nns_lsh"]
    return {
        "model_latency_us": cost.latency_us,
        "model_energy_uj": cost.energy_uj,
        "latency_speedup": g_lat / cost.latency_us,
        "energy_reduction": g_en / cost.energy_uj,
        "paper_latency_speedup": PAPER_END_TO_END["nns_latency_speedup"],
        "paper_energy_reduction": PAPER_END_TO_END["nns_energy_reduction"],
    }


# ---------------------------------------------------------------------------
# End-to-end (Sec. IV-C3)
# ---------------------------------------------------------------------------
def end_to_end_movielens(
    n_candidates: int = N_CANDIDATES, cal: Calibration = CAL
) -> dict:
    """The paper's MovieLens end-to-end figures (Sec. IV-C3) per query.

    The signature CMAs stay fixed at ``cdiv(3000, CMA_ROWS)``, the paper's
    3000-item catalog, whatever catalog the caller serves: the reference
    does the same, and the port keeps it for parity.
    """
    banks = mp.movielens_mapping().banks
    et = movielens_et_costs(cal)
    sig_cmas = cdiv(3000, mp.CMA_ROWS)

    dnn_f = crossbar_mlp_cost(ML_FILTER_DNN, banks, cal)
    dnn_r = crossbar_mlp_cost(ML_RANK_DNN, banks, cal)
    per_cand = et["ml_rank"] + dnn_r + OpCost(cal.t_ctrl_ns, 0.0)
    imars = (
        et["ml_filter"]
        + nns_cost(sig_cmas, cal)
        + dnn_f
        + per_cand.scale(n_candidates)
        + ctr_topk_cost(cal)
    )

    g_et_f = GPU_PAPER["ml_filter_et"]
    g_et_r = GPU_PAPER["ml_rank_et"]
    g_nns = GPU_PAPER["ml_nns_lsh"]
    g_dnn_f = GPU_IMPLIED["ml_dnn_filter"]
    g_dnn_r = GPU_IMPLIED["ml_dnn_rank_per_cand"]
    gpu_lat_us = (
        g_et_f[0] + g_nns[0] + g_dnn_f[0]
        + n_candidates * (g_et_r[0] + g_dnn_r[0])
    )
    gpu_en_uj = (
        g_et_f[1] + g_nns[1] + g_dnn_f[1]
        + n_candidates * (g_et_r[1] + g_dnn_r[1])
    )
    return {
        "imars_latency_us": imars.latency_us,
        "imars_energy_uj": imars.energy_uj,
        "imars_qps": 1e6 / imars.latency_us,
        "gpu_latency_us": gpu_lat_us,
        "gpu_energy_uj": gpu_en_uj,
        "gpu_qps": 1e6 / gpu_lat_us,
        "latency_speedup": gpu_lat_us / imars.latency_us,
        "energy_reduction": gpu_en_uj / imars.energy_uj,
        "paper_latency_speedup": PAPER_END_TO_END["ml_latency_speedup"],
        "paper_energy_reduction": PAPER_END_TO_END["ml_energy_reduction"],
        "paper_qps_imars": PAPER_END_TO_END["ml_qps_imars"],
        "paper_qps_gpu": PAPER_END_TO_END["ml_qps_gpu"],
    }


def end_to_end_criteo(cal: Calibration = CAL) -> dict:
    banks = mp.criteo_mapping().banks
    et = criteo_et_costs(cal)["criteo_rank"]
    dnn = crossbar_mlp_cost(CRITEO_BOTTOM_DNN, banks, cal) + crossbar_mlp_cost(
        CRITEO_TOP_DNN, banks, cal
    )
    imars = et + dnn + OpCost(cal.t_ctrl_ns, 0.0)

    g_et = GPU_PAPER["criteo_rank_et"]
    g_dnn = GPU_IMPLIED["criteo_dnn"]
    gpu_lat_us = g_et[0] + g_dnn[0]
    gpu_en_uj = g_et[1] + g_dnn[1]
    return {
        "imars_latency_us": imars.latency_us,
        "imars_energy_uj": imars.energy_uj,
        "gpu_latency_us": gpu_lat_us,
        "gpu_energy_uj": gpu_en_uj,
        "latency_speedup": gpu_lat_us / imars.latency_us,
        "energy_reduction": gpu_en_uj / imars.energy_uj,
        "paper_latency_speedup": PAPER_END_TO_END["criteo_latency_speedup"],
        "paper_energy_reduction": PAPER_END_TO_END["criteo_energy_reduction"],
    }


# ---------------------------------------------------------------------------
# Design-space exploration (Sec. III-A1 discussion: B, M, C trade-offs)
# ---------------------------------------------------------------------------
def design_space_lookup_cost(
    n_rows: int,
    pooled_lookups: int,
    cmas_per_mat: int,
    intrabank_fanin: int = 4,
    cal: Calibration = CAL,
) -> OpCost:
    """Latency/energy of one pooled ET lookup as a function of (C, fan-in).

    Larger C -> fewer mats but bigger intra-mat fan-in (the paper models this
    as added parasitic delay: we charge log2(C) gate levels on the tree);
    more mats -> more serialized intra-bank rounds (fan-in 4 per shot).
    """
    e_read, t_read = ARRAY_FOM["cma_read"]
    e_add, t_add = ARRAY_FOM["cma_add"]
    e_write, _ = ARRAY_FOM["cma_write"]
    e_im, t_im = ARRAY_FOM["intramat_add"]
    e_ib, t_ib = ARRAY_FOM["intrabank_add"]

    n_cmas = cdiv(n_rows, mp.CMA_ROWS)
    n_mats = cdiv(n_cmas, cmas_per_mat)
    # parasitic scaling of the intra-mat tree with its fan-in
    t_im_eff = t_im * (1 + 0.1 * math.log2(max(cmas_per_mat, 2)))
    rounds = max(1, cdiv(max(n_mats - 1, 1), intrabank_fanin - 1))
    latency = (
        pooled_lookups * (t_read + t_add)
        + t_im_eff
        + rounds * t_ib
        + 2 * cal.t_rsc_ns
    )
    energy = (
        pooled_lookups * (e_read + e_add + e_write)
        + e_im * n_mats
        + e_ib * rounds
        + (2 + n_mats) * e_shot(1, cal)
    )
    return OpCost(latency, energy)
