"""The pyramid levels of a pair that ops/kernels.py::search_route sends to
the GN route (build_templates, then gn_search), as the program counted
them: `Executable.routes` of the executable the window replayed, the most
recently used one in ops/graphs.py's cache.  None where the cache holds
none (the CPU) or the program keeps no route counts."""


def read(view, run):
    from of_dis_tpu_torch.ops import graphs

    held = graphs.cache.entries()
    routes = getattr(held[-1], "routes", None) if held else None
    return float(routes.get("gn", 0)) if routes is not None else None
