"""Out-of-core baseline engines (GraphChi, X-Stream, GridGraph I/O
schedules) and the paper's Table II analytic I/O model; host numpy, as the
systems they model run on CPUs."""

from .engines import DSWEngine, ESGEngine, PSWEngine, prepare_baseline_store
from .io_model import MODELS, IOModel, IOParams, io_table

__all__ = ["PSWEngine", "ESGEngine", "DSWEngine", "prepare_baseline_store",
           "IOModel", "IOParams", "MODELS", "io_table"]
