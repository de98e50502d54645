"""Generic name -> factory registry (the port's own copy of
mlcomp_tpu/utils/registry.py: the port imports nothing of the JAX
package).  YAML configs name models by string through it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Generic, Iterator, Optional, TypeVar

T = TypeVar("T")


class RegistryError(KeyError):
    pass


class Registry(Generic[T]):
    """A case-insensitive name → factory map with a decorator interface.

    >>> MODELS = Registry("models")
    >>> @MODELS.register("mlp")
    ... class MLP: ...
    >>> MODELS.get("MLP") is MLP
    True
    """

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, T] = {}

    @staticmethod
    def _key(name: str) -> str:
        return name.strip().lower().replace("-", "_")

    def register(self, name: Optional[str] = None, *, obj: Any = None):
        """Register ``obj`` under ``name``; usable as decorator or call."""
        if callable(name) and obj is None:
            # bare @registry.register (no parentheses)
            self._add(getattr(name, "__name__"), name)
            return name
        if obj is not None:
            self._add(name or getattr(obj, "__name__"), obj)
            return obj

        def deco(target):
            self._add(name or getattr(target, "__name__"), target)
            return target

        return deco

    def _add(self, name: str, obj: Any) -> None:
        key = self._key(name)
        if key in self._entries and self._entries[key] is not obj:
            raise RegistryError(
                f"{self.kind}: duplicate registration for {name!r}"
            )
        self._entries[key] = obj

    def get(self, name: str) -> T:
        try:
            return self._entries[self._key(name)]
        except KeyError:
            known = ", ".join(sorted(self._entries)) or "<empty>"
            raise RegistryError(
                f"{self.kind}: unknown name {name!r}; known: {known}"
            ) from None

    def create(self, name: str, /, *args, **kwargs):
        """Instantiate the registered factory."""
        return self.get(name)(*args, **kwargs)

    def __contains__(self, name: str) -> bool:
        return self._key(name) in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._entries))

    def __len__(self) -> int:
        return len(self._entries)

    def names(self):
        return sorted(self._entries)
