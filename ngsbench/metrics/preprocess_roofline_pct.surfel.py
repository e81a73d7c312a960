"""preprocess_roofline_pct.surfel: the preprocess kernels' surfel variant's
share of its bytes bound over the checked 2D Gaussian Splatting steps: the
least time of a step's forward and backward launch over every surfel
(``surfel_counts.preprocess_least_s``) over those launches' recorded
time."""

from ngsbench import surfel_counts


def read(t):
    s = [x for x in t.samples if x.get("SPF") and x.get("SPB")]
    if t.kind != "surfel_train" or not s:
        return None
    least = len(s) * surfel_counts.preprocess_least_s(t.facts["surfels"])
    return 100.0 * least / sum(x["SPF"] + x["SPB"] for x in s)
