"""The yardstick's arithmetic: the card's peaks, a histogram launch's
least work, and the FLOPs an AutoML fit's algorithm needs.

Nothing here imports the program. ``histogram_cost`` is a frozen copy
of ``transmogrifai_tpu_torch/models/kernels.py:450``; the rest counts
from shapes, grids, folds and the solvers' fixed trip counts, so a count
does not depend on which kernel runs.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Tuple

#: NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
PEAK = {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12,
        "tf32_flops_per_s": 495e12, "bf16_flops_per_s": 989e12}
#: what each term of a fit's count is priced at
DTYPE_PEAK = {"f32": PEAK["f32_flops_per_s"],
              "bf16": PEAK["bf16_flops_per_s"]}


def histogram_cost(G: int, n: int, d: int, S: int, m: int,
                   B: int, Gbins: int = 1) -> Dict[str, float]:
    """Frozen copy of ``transmogrifai_tpu_torch/models/kernels.py:450``.
    What one call must do at least: every input read once (``Gbins``
    binned matrices of int32 bins, f32 stats, int32 positions) and the
    output written once (bytes), and one f32 add per (instance, row,
    feature, stat) (operations). ``mma`` and ``mma_flop`` count what
    the kernel runs on the tensor cores in bf16 mode (three times that
    in exact mode): per instance, 16-row k-step of a node's rows and
    feature, ceil(B/16) x ceil(S/8) mma of m16n8k16, 4096 FLOP each."""
    nbytes = 4.0 * (Gbins * n * d + G * n * S + G * n + G * m * S * d * B)
    mma = float(G) * -(-n // 16) * d * -(-B // 16) * -(-S // 8)
    return {"bytes": nbytes, "adds": float(G) * n * d * S, "mma": mma,
            "mma_flop": 4096.0 * mma}


def histogram_bound_s(shape: Tuple[int, ...]) -> float:
    """The least time one histogram launch of ``shape`` = (G, n, d, S, m,
    B[, Gbins]) can take: the larger of its bytes at the HBM rate and its
    adds at the f32 rate."""
    c = histogram_cost(*shape)
    return max(c["bytes"] / PEAK["hbm_bytes_per_s"],
               c["adds"] / PEAK["f32_flops_per_s"])


# ---------------------------------------------------------------------------
# An AutoML fit's algorithmic FLOPs
# ---------------------------------------------------------------------------

#: the tree families' static shapes: (classes' stat channels S, levels
#: hyper and its cap, rounds hyper, trees hyper)
TREE_SHAPES = {
    "DecisionTreeClassifier": {"S": 5, "depth_cap": 5},
    "RandomForestClassifier": {"S": 5, "depth_cap": 5, "trees": "numTrees"},
    "GBTClassifier": {"S": 3, "depth_cap": 5, "rounds": "maxIter"},
    "XGBoostClassifier": {"S": 3, "depth_cap": 6, "rounds": "maxIter"},
}
#: the linear solvers' fixed trip counts (``models/linear.py``)
NEWTON_ITERS, FISTA_ITERS, SVC_ITERS, POWER_ITERS = 15, 200, 200, 12


def tree_flops(family: str, hyper: Mapping[str, float], n: int,
               d: int) -> float:
    """Histogram adds one fit of ``family`` at ``hyper`` needs over ``n``
    weighted rows: n*d*S a level, for every level, round and tree the
    hypers ask for."""
    s = TREE_SHAPES[family]
    levels = min(int(hyper.get("maxDepth", s["depth_cap"])), s["depth_cap"])
    trees = int(hyper.get(s["trees"], 1)) if "trees" in s else 1
    rounds = int(hyper.get(s["rounds"], 1)) if "rounds" in s else 1
    return float(n) * d * s["S"] * levels * trees * rounds


def linear_flops(family: str, hyper: Mapping[str, float], n: int,
                 d: int) -> float:
    """Products over the (n, d+1) design matrix one fit needs: 2np a
    product with a vector, 2np^2 a Gram."""
    p = d + 1
    mv = 2.0 * n * p
    if family == "LogisticRegression":
        newton = NEWTON_ITERS * (2 * mv + 2.0 * n * p * p)
        if float(hyper.get("elasticNetParam", 0.0)) == 0.0:
            return newton
        return newton + (POWER_ITERS + 1) * 2 * mv + FISTA_ITERS * 2 * mv
    if family == "LinearSVC":
        return (POWER_ITERS + 1) * 2 * mv + SVC_ITERS * 2 * mv
    if family == "NaiveBayes":
        return 2 * 2.0 * n * 2 * d            # per-class sums of x and x^2
    raise KeyError(family)


def fit_terms(validation: Iterable[Mapping], winner: str,
              winner_hyper: Mapping[str, float], n_train: int, d: int,
              folds: int) -> List[Tuple[float, str]]:
    """(FLOPs, dtype) terms of one selector fit: every family's grid on
    each fold's training rows ((folds-1)/folds of the split), scoring of
    each fold's validation rows, and the winner's refit on the whole
    split. Histogram adds are priced in bf16 (the configuration's
    operand type), everything else in f32."""
    n_fold = n_train * (folds - 1) / folds
    n_val = n_train / folds
    terms: List[Tuple[float, str]] = []

    def one(family, hyper, n):
        if family in TREE_SHAPES:
            terms.append((tree_flops(family, hyper, n, d), "bf16"))
        else:
            terms.append((linear_flops(family, hyper, n, d), "f32"))

    for res in validation:
        for hyper in res["grid"]:
            for _ in range(folds):
                one(res["family"], hyper, n_fold)
                if res["family"] not in TREE_SHAPES:
                    terms.append((2.0 * n_val * (d + 1), "f32"))
    one(winner, winner_hyper, n_train)
    return terms


def mfu_seconds(terms: Iterable[Tuple[float, str]]) -> float:
    """The least time the terms take at their dtypes' peaks."""
    return sum(f / DTYPE_PEAK[t] for f, t in terms)


# ---------------------------------------------------------------------------
# A CTR selector fit's algorithmic FLOPs
# ---------------------------------------------------------------------------

#: the CTR selector's family labels in its summary
SPARSE_LABELS = {"SparseLogisticRegression": "adagrad", "SparseFTRL": "ftrl",
                 "SparseFactorizationMachine": "fm"}
#: FLOPs a bucket's optimizer update takes: Adagrad (g^2, add, sqrt,
#: divide, scale, subtract), FTRL (sigma's two roots, z's and n's
#: updates, the closed-form weight)
UPDATE_FLOPS = {"adagrad": 6.0, "fm": 6.0, "ftrl": 12.0}


def sparse_step_flops(family: str, I: int, b: int, K: int, d: int, k: int,
                      B: int) -> float:
    """One minibatch of I instances: each row's logit (K lookups summed,
    a d-wide dot product; the FM's K x k interaction), its gradient
    scattered back (K adds, the dense product; the FM's K x k), and every
    bucket's update of every table."""
    row = 2.0 * K + 4.0 * d + 8.0
    tables = B
    if family == "fm":
        row += 8.0 * K * k
        tables += B * k
    return I * (b * row + UPDATE_FLOPS[family] * tables)


def sparse_fit_flops(validation, winner: str, n_train: int, st, K: int,
                     d: int, B: int) -> float:
    """A CTR selector fit: every family's (fold x grid) instances over
    the epochs' batches and one validation pass, then the winner's refit;
    ``validation`` is the summary's list, ``st`` the selector's stream
    parameters."""
    b = st["batch_size"]
    steps = -(-n_train // b)
    fams: dict = {}
    for r in validation:
        fam = SPARSE_LABELS[r["family"]]
        fams[fam] = fams.get(fam, 0) + 1
    total = 0.0
    for fam, G in fams.items():
        I = G * st["n_folds"]
        total += st["epochs"] * steps * sparse_step_flops(
            fam, I, b, K, d, st["fm_dim"], B)
        total += I * n_train * (2.0 * K + 2.0 * d) * (
            1 + (4.0 * st["fm_dim"] if fam == "fm" else 0))
    total += st["refit_epochs"] * steps * sparse_step_flops(
        winner, 1, b, K, d, st["fm_dim"], B)
    return total
