"""Version stamping (reference pkg/version/version.go:25-33)."""

from __future__ import annotations

import platform
import sys

# Stamped at release; overridable at build/packaging time, like the
# reference's -ldflags -X injection.
VERSION = "0.1.0"
GIT_SHA = "Not provided."
BUILT = "Not provided."
API_VERSION = "v1alpha1"


def info(api_version: str = API_VERSION) -> list[str]:
    """reference version.go:42-52."""
    return [
        f"API Version: {api_version}",
        f"Version: {VERSION}",
        f"Git SHA: {GIT_SHA}",
        f"Built At: {BUILT}",
        f"Python Version: {platform.python_version()}",
        f"Platform: {sys.platform}/{platform.machine()}",
    ]


def print_version_and_exit(api_version: str = API_VERSION) -> None:
    """reference version.go:36-40."""
    for line in info(api_version):
        print(line)
    raise SystemExit(0)
