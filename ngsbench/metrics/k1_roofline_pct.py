"""k1_roofline_pct: K1's share of its roofline over the counted frames: the
least time the work of those views needs (``counts.k1_least_s``, from the
reference's pair counts) over K1's recorded time on them."""

from ngsbench import counts


def read(t):
    s = [x for x in t.samples if x.get("K1")]
    if not s:
        return None
    least = sum(counts.k1_least_s(x["counts"], t.facts["tiles"])[0] for x in s)
    return 100.0 * least / sum(x["K1"] for x in s)
