"""Version stamping (counterpart of the JAX package's version.py): the
package version and the checkout's git commit."""

import os
import subprocess

__version__ = "0.1.0"


def git_commit() -> str:
    """The short commit of the checkout that holds the package, or
    "unknown" outside a git checkout (an unpacked archive)."""
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "--short", "HEAD"], stderr=subprocess.DEVNULL,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            timeout=10).decode().strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
