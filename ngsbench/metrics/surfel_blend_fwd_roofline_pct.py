"""surfel_blend_fwd_roofline_pct: the surfel blend forward kernel's share
of its roofline over the checked 2D Gaussian Splatting steps: the least
time their forward blend needs (``surfel_counts.fwd_least_s``, from the
reference's pair counts) over the kernel's recorded time in them."""

from ngsbench import surfel_counts


def read(t):
    s = [x for x in t.samples if x.get("SBF")]
    if t.kind != "surfel_train" or not s:
        return None
    least = sum(surfel_counts.fwd_least_s(x["counts"], t.facts["tiles"])[0]
                for x in s)
    return 100.0 * least / sum(x["SBF"] for x in s)
