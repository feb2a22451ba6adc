"""The search's share of its roofline in the traced window, in %: the least
time the card's peaks allow for one pair's search work at every level
(work.py's `level_search` stage: bytes and FP32 operations per pair) over
the device time per pair of both search kernels, level_search and
gn_search, whichever of them ops/kernels.py::search_route gave each level.
None where neither kernel ran or the card is not in the table of peaks."""

from work import bound_s, pair_work, peak

KERNELS = ("level_search", "gn_search")


def read(view, run):
    times = [t for t in (view.kernel_seconds(k) for k in KERNELS) if t is not None]
    pk = peak(run.extra.get("device_name", ""))
    w = pair_work(run.params, run.width, run.height).get("level_search")
    if not times or pk is None or w is None or not view.pairs:
        return None
    return 100.0 * bound_s(*w, pk) / (sum(times) / view.pairs)
