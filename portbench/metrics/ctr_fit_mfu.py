"""The whole CTR fit's share of the card's f32 peak: the FLOPs its
algorithm needs (``costs.sparse_fit_flops``: lookups, dot products, the
FM's pairwise terms, gradients and every bucket's update, a step; one
validation pass; the refit) over the fits' wall, in percent."""
from ..costs import PEAK, SPARSE_LABELS, sparse_fit_flops


def read(run):
    need = wall = 0.0
    for f in run["fits"]:
        s = f["summary"]
        need += sparse_fit_flops(s["validationResults"],
                                 SPARSE_LABELS[s["bestModel"]["family"]],
                                 f["n_train"], f["stream"], f["K"], f["d"],
                                 f["buckets"])
        wall += f["wall_s"]
    return 100.0 * need / PEAK["f32_flops_per_s"] / wall

