from .reader import (  # noqa: F401
    ForwardScanner,
    IsolationLevel,
    KeyIsLockedError,
    PointGetter,
    Statistics,
)
