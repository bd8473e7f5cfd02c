"""Copies of the JAX package's network model (adapter transfers between
servers, their links' load) and analytic cost model (operating points for
placement). The cost model is a model of the paper's A100 fleet, calibrated
to the paper's figures; its constants are not measurements of the card the
port runs on. The simulator (``cluster/server.py``, ``simulator.py``) is not
ported yet."""
from .costmodel import (ServerModel, co_serving_slowdown, make_server,
                        profile_operating_points)
from .network import NetworkModel

__all__ = ["ServerModel", "co_serving_slowdown", "make_server",
           "profile_operating_points", "NetworkModel"]
