"""The published FT-Transformer fit's share of the card's bf16 dense
peak: its FLOPs (``ft_costs.fit_flops``: the rows stepped, forward and
backward, and the rows scored, counted from shapes and the family's
counter) over the fits' wall, in percent. None where the fits carry no
counter."""
from ..costs import PEAK
from ..ft_costs import fit_flops


def read(run):
    fits = run["fits"]
    if not all(f.get("ft") for f in fits):
        return None
    need = sum(fit_flops(f) for f in fits)
    wall = sum(f["wall_s"] for f in fits)
    return 100.0 * need / PEAK["bf16_flops_per_s"] / wall
