"""Exception types with captured caller info.

Counterpart of `openfhe_tpu/utils/exception.py` (the same code). Reference
analog: src/core/include/utils/exception.h
(OpenFHEException + OPENFHE_THROW macro capturing file/line/function,
get-call-stack.cpp demangled stack traces).  Python tracebacks already
carry the stack; we keep the reference's exception taxonomy and attach the
call site for parity with `GetCallerInfo`.
"""

from __future__ import annotations

import inspect


class OpenFHEException(Exception):
    """(reference OpenFHEException, exception.h)"""

    def __init__(self, message: str):
        frame = inspect.currentframe()
        caller = frame.f_back if frame else None
        # walk out of this module's constructors
        while caller and caller.f_globals.get("__name__") == __name__:
            caller = caller.f_back
        if caller:
            info = inspect.getframeinfo(caller)
            self.caller_info = f"{info.filename}:{info.lineno} " \
                               f"({info.function})"
            message = f"{message} [{self.caller_info}]"
        else:
            self.caller_info = ""
        super().__init__(message)


class ConfigException(OpenFHEException):
    """Invalid parameters / configuration (reference config_error)."""


class MathException(OpenFHEException):
    """Arithmetic domain errors (reference math_error)."""


class NotImplementedException(OpenFHEException, NotImplementedError):
    """(reference not_implemented_error)"""


class NotAvailableException(OpenFHEException):
    """Feature disabled or not available in this build
    (reference not_available_error)."""


class DeserializationException(OpenFHEException):
    """(reference deserialize_error)"""


def openfhe_throw(message: str, exc_type=OpenFHEException):
    """(reference OPENFHE_THROW)"""
    raise exc_type(message)
