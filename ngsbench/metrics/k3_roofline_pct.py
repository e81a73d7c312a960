"""k3_roofline_pct: K3's share of its roofline over the checked neural
training steps: the least time their z-buffer needs
(``neural_counts.k3_least_s``, from the reference's counts of the same
views) over K3's recorded time in them."""

from ngsbench import neural_counts


def read(t):
    s = [x for x in t.samples if x.get("K3")]
    if t.kind != "neural_train" or not s:
        return None
    least = sum(neural_counts.k3_least_s(x["counts"])[0] for x in s)
    return 100.0 * least / sum(x["K3"] for x in s)
