from .production import (production_adapters, production_trace,
                         production_trace_with_meta)
from .synth import make_adapters, six_traces, synth_trace
