"""Core definitions: duplicate policies, error handling, zero/NaN tests.

Array-native re-design of the reference's L0 core layer
(/root/reference/slib/spsparse/spsparse.hpp:25-103, spsparse.cpp:12-31):

* ``DuplicatePolicy`` — what consolidation does with duplicate indices
  (reference ``spsparse.hpp:25-26``).
* ``SpSparseError`` — structured exception (reference ``Exception``,
  ``spsparse.hpp:30-38``).
* A pluggable error handler (reference's ``error_ptr spsparse_error`` global,
  ``spsparse.hpp:47-54``); the default logs and raises.
* ``isnone`` — the "value counts as structurally absent" test used by
  consolidate and multiply (reference ``spsparse.hpp:95-103``).

Unlike the C++ reference, in-jit validation cannot raise Python exceptions;
host-side entry points validate eagerly, and jitted code uses the padding
conventions in :mod:`spsparse_tpu.core.coo` instead of runtime errors.
"""

from __future__ import annotations

import enum
import logging
from typing import Callable

import jax.numpy as jnp
import numpy as np

logger = logging.getLogger("spsparse_tpu")

__all__ = [
    "DuplicatePolicy",
    "SpSparseError",
    "set_error_handler",
    "set_dump_stack_on_error",
    "spsparse_error",
    "isnone",
    "ROW_MAJOR",
    "COL_MAJOR",
]


class DuplicatePolicy(enum.Enum):
    """What to do when duplicate indices are encountered during consolidation.

    Mirrors the reference semantics (``spsparse.hpp:18-26``):

    * ``ADD`` (default): sum duplicate values.
    * ``LEAVE_ALONE``: keep the *first* value encountered (insertion order).
    * ``REPLACE``: keep the *last* value encountered (insertion order).

    First/last are well-defined because consolidation sorts *stably*
    (reference ``algorithm.hpp:404-406,424``).
    """

    LEAVE_ALONE = 0
    ADD = 1
    REPLACE = 2


class SpSparseError(Exception):
    """Structured error raised by spsparse-tpu host-side validation.

    Plays the role of ``spsparse::Exception`` (reference ``spsparse.hpp:30-38``).
    """


_dump_stack: bool = False


def set_dump_stack_on_error(enabled: bool = True) -> None:
    """Make the default handler dump the Python stack to stderr before
    raising — the analogue of the reference's optional Everytrace hook,
    which calls ``everytrace_exit(-1)`` for a stack dump when built with
    ``-DUSE_EVERYTRACE`` (reference ``spsparse.cpp:21-23``,
    ``CMakeLists.txt:7-16``). Unlike Everytrace this does not exit the
    process; the structured exception still propagates."""
    global _dump_stack
    _dump_stack = enabled


def _default_error(retcode: int, msg: str) -> None:
    """Default handler: log then raise (reference ``spsparse.cpp:12-28``)."""
    logger.error("spsparse error (retcode=%d): %s", retcode, msg)
    if _dump_stack:
        import sys
        import traceback
        traceback.print_stack(file=sys.stderr)
    raise SpSparseError(msg)


_error_handler: Callable[[int, str], None] = _default_error


def set_error_handler(handler: Callable[[int, str], None] | None) -> None:
    """Install a custom error handler (reference ``spsparse.hpp:47-54``).

    Pass ``None`` to restore the default (log + raise ``SpSparseError``).
    The handler receives ``(retcode, message)`` and is expected to raise.
    """
    global _error_handler
    _error_handler = _default_error if handler is None else handler


def spsparse_error(retcode: int, msg: str, *args) -> None:
    """Invoke the pluggable error handler with a printf-style message."""
    if args:
        msg = msg % args
    _error_handler(retcode, msg)
    # Defensive: if a user handler returns instead of raising, still raise so
    # callers never continue with invalid state.
    raise SpSparseError(msg)


# Sort orders for rank-2 arrays (reference spsparse.cpp:30-31).
ROW_MAJOR: tuple[int, int] = (0, 1)
COL_MAJOR: tuple[int, int] = (1, 0)


def isnone(v, zero_nan: bool = False):
    """True where a value counts as structurally zero.

    Reference ``spsparse.hpp:95-103``: ``v == 0``, additionally NaN when
    ``zero_nan`` is set. Works on scalars and arrays (jnp or np).

    Note the reference has an inconsistency where the *mid-stream* skip in
    consolidate drops only zeros regardless of ``zero_nan``
    (``algorithm.hpp:291`` vs ``:274``); this framework implements the
    documented semantics uniformly (NaNs dropped everywhere iff ``zero_nan``).
    """
    xp = jnp if isinstance(v, jnp.ndarray) else np
    if zero_nan:
        return xp.isnan(v) | (v == 0)
    return v == 0
