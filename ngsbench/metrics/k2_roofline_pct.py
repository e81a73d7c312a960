"""k2_roofline_pct: K2's share of its roofline over the checked training
steps: the least time their backward blend needs (``counts.k2_least_s``,
from the reference's pair counts) over K2's recorded time in them."""

from ngsbench import counts


def read(t):
    s = [x for x in t.samples if x.get("K2")]
    if t.kind != "train" or not s:
        return None
    least = sum(counts.k2_least_s(x["counts"], t.facts["tiles"])[0] for x in s)
    return 100.0 * least / sum(x["K2"] for x in s)
