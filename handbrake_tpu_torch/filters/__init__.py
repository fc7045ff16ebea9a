"""Filter suite of the port (reference: libhb filters, SURVEY.md §2.4).
Ported so far: crop/scale and the framerate shaper; the graph refuses
every other filter id with NotImplementedError."""
from .base import (Filter, FilterError, FilterInit, create_filter,  # noqa
                   register, registry)
from .graph import FilterGraph  # noqa: F401
