"""The package logger (counterpart of the JAX package's utils/logging.py).

`get_logger()` reads SKT_LOG_LEVEL (debug, info, warning (default), error,
critical) and, where SKT_LOG_DIR is set, writes to a rotating file
sgl_kernel_npu_tpu_torch.log there (10 MB, five backups; a symlinked or
world-writable directory is refused and the logger falls back to stderr).
`log_parameters` logs a function's call signature at DEBUG level.
"""

from __future__ import annotations

import functools
import logging
import logging.handlers
import os
import stat

from . import env

_LOGGER_NAME = "sgl_kernel_npu_tpu_torch"
_MAX_BYTES = 10 << 20
_BACKUP_COUNT = 5


def _parse_level(raw: str) -> int:
    return {
        "debug": logging.DEBUG,
        "info": logging.INFO,
        "warning": logging.WARNING,
        "error": logging.ERROR,
        "critical": logging.CRITICAL,
    }.get(raw.strip().lower(), logging.WARNING)


def _file_handler(log_dir: str) -> logging.Handler:
    """A rotating file handler in log_dir, owner-only; raises OSError for a
    symlinked or world-writable directory."""
    if os.path.islink(log_dir):
        raise OSError(f"log dir {log_dir} is a symlink; refusing")
    os.makedirs(log_dir, mode=0o750, exist_ok=True)
    if os.stat(log_dir).st_mode & stat.S_IWOTH:
        raise OSError(f"log dir {log_dir} is world-writable; refusing")
    path = os.path.join(log_dir, f"{_LOGGER_NAME}.log")
    handler = logging.handlers.RotatingFileHandler(path, maxBytes=_MAX_BYTES,
                                                   backupCount=_BACKUP_COUNT)
    os.chmod(path, 0o600)
    return handler


@functools.lru_cache(maxsize=1)
def get_logger() -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    logger.setLevel(_parse_level(env.env_str("SKT_LOG_LEVEL", "warning")))
    if logger.handlers:
        return logger
    handler: logging.Handler = logging.StreamHandler()
    log_dir = env.env_str("SKT_LOG_DIR", "")
    failed = None
    if log_dir:
        try:
            handler = _file_handler(log_dir)
        except OSError as e:        # stderr instead; never fail the caller
            failed = e
    handler.setFormatter(logging.Formatter(
        "[%(asctime)s] [%(levelname)s] [%(process)d] %(name)s: %(message)s"))
    logger.addHandler(handler)
    logger.propagate = False
    if failed is not None:
        logger.warning("file logging disabled: %s", failed)
    return logger


def log_parameters(fn):
    """DEBUG-level call-signature logging decorator."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        logger = get_logger()
        if logger.isEnabledFor(logging.DEBUG):
            parts = [repr(a) for a in args] + [f"{k}={v!r}" for k, v in kwargs.items()]
            logger.debug("%s(%s)", fn.__qualname__, ", ".join(parts))
        return fn(*args, **kwargs)

    return wrapper
