"""Filter suite of the port (reference: libhb filters, SURVEY.md §2.4).
Every filter of the JAX package but the subtitle burn-in (render_sub),
which the graph refuses with NotImplementedError."""
from .base import (Filter, FilterError, FilterInit, create_filter,  # noqa
                   register, registry)
from .graph import FilterGraph  # noqa: F401
