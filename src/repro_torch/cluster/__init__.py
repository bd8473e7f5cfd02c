"""Copies of the JAX package's cluster simulator (``server.py``,
``simulator.py``), network model (adapter transfers between servers,
their links' load) and analytic cost model (operating points for
placement). The cost model is a model of the paper's A100 fleet,
calibrated to the paper's figures; its constants are not measurements of
the card the port runs on.

Exports resolve lazily (PEP 562), as the original's ``__init__`` does.
"""
_EXPORTS = {
    "ServerModel": "costmodel", "co_serving_slowdown": "costmodel",
    "make_server": "costmodel", "profile_operating_points": "costmodel",
    "NetworkModel": "network",
    "SimRequest": "server", "SimServer": "server",
    "ClusterSimulator": "simulator", "SimResult": "simulator",
    "max_rps_under_slo": "simulator", "min_servers_under_slo": "simulator",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    import importlib
    mod = _EXPORTS.get(name)
    if mod is not None:
        return getattr(importlib.import_module(f".{mod}", __name__), name)
    try:                         # plain submodule access (pkg.network)
        return importlib.import_module(f".{name}", __name__)
    except ImportError:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}") from None


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
