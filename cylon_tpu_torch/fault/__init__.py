"""Typed failure domains and deterministic fault injection (counterpart of
cylon_tpu/fault/): ``errors.py`` is the whole taxonomy, ``inject.py`` the
spill seams and the ``CYLON_TPU_TORCH_FAULTS`` grammar. The other seams
come with serving and operations (ROADMAP.md A9)."""
from .errors import (  # noqa: F401
    SCOPE_CONTEXT,
    SCOPE_QUERY,
    SCOPE_TABLE,
    CylonError,
    QueryExecError,
    QueryTimeoutError,
    SchedulerClosedError,
    SpillIOError,
    StreamIngestError,
    WorkerDiedError,
)
from . import inject  # noqa: F401
from .inject import SEAMS, FaultSpecError, active, fired, parse_spec, refresh, reset  # noqa: F401

# inject.check is not re-exported by value: refresh() rebinds it, so sites
# reach it through the module attribute, ``fault.inject.check(...)``.
