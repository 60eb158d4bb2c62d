"""The whole fit's share of the card's peak: the FLOPs the fit's
algorithm needs (``costs.fit_terms``: every family's grid on each
fold, the winner's refit; histogram adds priced at the bf16 peak, the
linear products at the f32 peak) in their least time, over the fits'
wall, in percent."""
from ..costs import fit_terms, mfu_seconds


def read(run):
    need = 0.0
    wall = 0.0
    for f in run["fits"]:
        s = f["summary"]
        best = s["bestModel"]
        need += mfu_seconds(fit_terms(s["validationResults"], best["family"],
                                      best["hyper"], f["n_train"], f["d"],
                                      f["folds"]))
        wall += f["wall_s"]
    return 100.0 * need / wall
