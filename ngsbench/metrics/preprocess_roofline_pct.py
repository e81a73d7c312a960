"""preprocess_roofline_pct: the preprocess kernels' share of their bytes
bound over the counted Scaffold-GS steps: the least time their three
launches a step need (``scaffold_counts.preprocess_least_s``: the
prefilter over the anchors, the forward and the backward over the
candidates of the visible anchors, from the reference's counts) over those
launches' recorded time (the steps whose records the profiler kept)."""

from ngsbench import scaffold_counts


def read(t):
    s = [x for x in t.samples if x.get("preprocess_s")]
    if t.kind != "scaffold_train" or not s:
        return None
    k = t.facts["n_offsets"]
    least = sum(scaffold_counts.preprocess_least_s(x["counts"], k) for x in s)
    return 100.0 * least / sum(x["preprocess_s"] for x in s)
