"""Locate the user frame that invoked a horovod_tpu_torch API (port of
``horovod_tpu/utils/callsite.py``).

Used by the deterministic auto-namer (ops/collectives.py) and the
coordinator's duplicate-name diagnostic: both need "where in the *user's*
program did this collective come from", skipping every frame inside the
package itself. A ``sys._getframe`` walk, no traceback objects, so it is
cheap enough for the submission path.
"""

import os
import sys

# horovod_tpu_torch/ package root; frames under it are framework internals.
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def user_frame(skip=1):
    """First stack frame outside the package: ``(filename, lineno,
    qualname)``. Falls back to the outermost examined frame when the whole
    stack is internal (a hook on autograd's thread, the cycle thread)."""
    f = sys._getframe(skip)
    last = f
    while f is not None:
        if not f.f_code.co_filename.startswith(_PKG_ROOT):
            break
        last = f
        f = f.f_back
    frame = f if f is not None else last
    code = frame.f_code
    qualname = getattr(code, "co_qualname", code.co_name)
    return code.co_filename, frame.f_lineno, qualname


def format_user_frame(skip=2):
    """``file.py:lineno (qualname)`` for the calling user frame."""
    filename, lineno, qualname = user_frame(skip=skip)
    return f"{filename}:{lineno} ({qualname})"
