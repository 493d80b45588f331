"""Plugin arguments: string map + typed parse helpers
(reference pkg/scheduler/framework/arguments.go:26-46)."""

from __future__ import annotations

from typing import Mapping, Optional


class Arguments(dict):
    """``map[string]string`` with GetInt semantics: missing/empty/bad
    values leave the default untouched (reference arguments.go:33-46)."""

    def __init__(self, data: Optional[Mapping[str, str]] = None) -> None:
        super().__init__({str(k): str(v) for k, v in (data or {}).items()})

    def get_int(self, key: str, default: int) -> int:
        value = self.get(key, "")
        if not value:
            return default
        try:
            return int(value)
        except ValueError:
            return default

    def get_float(self, key: str, default: float) -> float:
        value = self.get(key, "")
        if not value:
            return default
        try:
            return float(value)
        except ValueError:
            return default

    def get_bool(self, key: str, default: bool) -> bool:
        value = self.get(key, "").lower()
        if not value:
            return default
        if value in ("true", "1", "yes"):
            return True
        if value in ("false", "0", "no"):
            return False
        return default
