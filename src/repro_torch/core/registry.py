"""MapRegistry — unified per-(domain, logic) registration of thread maps.

The PyTorch port of ``repro.core.registry``.  Every mapping implementation —
ground truth or LLM-derived variant — registers one or more *tiers* under a
``(domain, logic)`` key:

  scalar      exact python-int reference ``f(lam) -> coords`` (the gold tier),
  unmap       exact inverse ``f(*coords) -> lam``,
  numpy       vectorized exact int64 ``f(lams) -> (N, dim)`` (10^6 validation),
  torch       int64 tensor map ``f(lams, ndigits=13) -> (N, dim)``,
  pallas      the in-kernel coordinate emitter ``f(lam_block, ndigits) ->
              [axes]``; here the plain torch version of what the CUDA map
              kernel computes (the name is kept from the JAX package),
  membership  the in-kernel BB discard test ``f(axes, ndigits) -> bool
              mask``; here the plain torch version of the CUDA membership
              kernel's test.

A new geometry is a one-file addition: define the tier callables and call
:func:`register_map` (see ``core/maps/fractal.py`` for the pattern).  Known
plugin modules are imported lazily on the first lookup miss so consumers can
import the registry alone and still resolve every built-in domain.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Iterable, Mapping

TIERS = ("scalar", "unmap", "numpy", "torch", "pallas", "membership")

#: modules that register the built-in domains/tiers when imported.
DEFAULT_PLUGINS = (
    "repro_torch.core.maps",                    # scalar/unmap/numpy/torch
    "repro_torch.kernels.domain_map.geometry",  # pallas/membership tiers
)


@dataclasses.dataclass
class MapEntry:
    """All registered tiers + metadata for one (domain, logic) pair."""

    domain: str
    logic: str
    tiers: dict[str, Callable]
    complexity_class: str | None = None
    ground_truth: bool = False

    def tier(self, name: str) -> Callable:
        if name not in self.tiers:
            raise KeyError(
                f"({self.domain!r}, {self.logic!r}) has no {name!r} tier; "
                f"registered: {sorted(self.tiers)}")
        return self.tiers[name]

    @property
    def scalar(self) -> Callable:
        return self.tier("scalar")


class MapRegistry:
    """Plugin registry mapping (domain, logic) -> tiered map implementations."""

    def __init__(self, plugins: Iterable[str] = ()):
        self._entries: dict[tuple[str, str], MapEntry] = {}
        self._ground_truth: dict[str, str] = {}  # domain -> canonical logic
        self._plugins = tuple(plugins)
        self._plugins_loaded = False

    # -- registration ------------------------------------------------------
    def register(
        self,
        domain: str,
        logic: str,
        *,
        tiers: Mapping[str, Callable],
        complexity_class: str | None = None,
        ground_truth: bool = False,
        overwrite: bool = False,
    ) -> MapEntry:
        """Register (or merge into) the entry for (domain, logic)."""
        unknown = set(tiers) - set(TIERS)
        if unknown:
            raise ValueError(f"unknown tiers {sorted(unknown)}; have {TIERS}")
        key = (domain, logic)
        entry = self._entries.get(key)
        if entry is None:
            entry = MapEntry(domain=domain, logic=logic, tiers={},
                             complexity_class=complexity_class,
                             ground_truth=ground_truth)
            self._entries[key] = entry
        for name, fn in tiers.items():
            if name in entry.tiers and not overwrite:
                raise ValueError(
                    f"tier {name!r} already registered for {key}; "
                    f"pass overwrite=True to replace")
            entry.tiers[name] = fn
        if complexity_class is not None:
            entry.complexity_class = complexity_class
        if ground_truth:
            current = self._ground_truth.get(domain, logic)
            if current != logic and not overwrite:
                raise ValueError(
                    f"domain {domain!r} already has ground-truth logic "
                    f"{current!r}; pass overwrite=True to replace it with "
                    f"{logic!r}")
            entry.ground_truth = True
            self._ground_truth[domain] = logic
        return entry

    # -- plugin loading ----------------------------------------------------
    def _load_plugins(self) -> None:
        if self._plugins_loaded:
            return
        for mod in self._plugins:
            importlib.import_module(mod)
        # marked only after every import succeeds, so a failed plugin import
        # surfaces again (as the ImportError) on the next lookup instead of
        # degrading into misleading missing-tier KeyErrors
        self._plugins_loaded = True

    # -- resolution --------------------------------------------------------
    def resolve(self, domain: str, logic: str | None = None) -> MapEntry:
        """Entry for (domain, logic); logic=None -> the ground-truth entry."""
        if logic is None:
            if domain not in self._ground_truth:
                self._load_plugins()
            if domain not in self._ground_truth:
                raise KeyError(
                    f"no ground-truth map registered for domain {domain!r}; "
                    f"have {sorted(self._ground_truth)}")
            logic = self._ground_truth[domain]
        key = (domain, logic)
        if key not in self._entries:
            self._load_plugins()
        if key not in self._entries:
            raise KeyError(
                f"no map registered for {key}; have {sorted(self._entries)}")
        return self._entries[key]

    def tier(self, domain: str, logic: str | None, tier_name: str) -> Callable:
        """Resolve one tier callable, loading plugin modules if needed."""
        entry = self.resolve(domain, logic)
        if tier_name not in entry.tiers:
            # the tier may live in a not-yet-imported plugin (e.g. pallas
            # tiers register from the kernels package) — load and retry.
            self._load_plugins()
            entry = self.resolve(domain, logic)
        return entry.tier(tier_name)

    def ground_truth(self, domain: str) -> MapEntry:
        return self.resolve(domain, None)

    def logics(self, domain: str) -> list[str]:
        """All logic classes registered for a domain (ground truth first)."""
        self._load_plugins()
        found = sorted(l for (d, l) in self._entries if d == domain)
        gt = self._ground_truth.get(domain)
        if gt in found:
            found.remove(gt)
            found.insert(0, gt)
        return found

    def domains(self) -> list[str]:
        self._load_plugins()
        return sorted({d for (d, _) in self._entries})

    def items(self) -> list[tuple[tuple[str, str], MapEntry]]:
        self._load_plugins()
        return sorted(self._entries.items())

    def snapshot(self) -> dict[tuple[str, str], MapEntry]:
        """Currently registered entries WITHOUT triggering plugin loading
        (used by plugin modules themselves to build compatibility views)."""
        return dict(self._entries)

    def __contains__(self, key: tuple[str, str]) -> bool:
        self._load_plugins()
        return tuple(key) in self._entries

    def __len__(self) -> int:
        self._load_plugins()
        return len(self._entries)


#: process-global registry every production consumer resolves through.
REGISTRY = MapRegistry(plugins=DEFAULT_PLUGINS)


def get_registry() -> MapRegistry:
    return REGISTRY


def register_map(
    domain: str,
    logic: str,
    *,
    tier: str = "scalar",
    tiers: Mapping[str, Callable] | None = None,
    complexity_class: str | None = None,
    ground_truth: bool = False,
    overwrite: bool = False,
    registry: MapRegistry | None = None,
):
    """Register a map implementation.

    Two forms:

      # direct — register several tiers at once:
      register_map("gasket2d", "bitwise", ground_truth=True,
                   tiers={"scalar": f, "numpy": g, "torch": h})

      # decorator — register the decorated callable under one tier:
      @register_map("tri2d", "sqrt_loop", tier="scalar",
                    complexity_class="O(1)")
      def map_tri2d_sqrt_loop(lam): ...
    """
    reg = registry if registry is not None else REGISTRY
    if tiers is not None:
        return reg.register(domain, logic, tiers=dict(tiers),
                            complexity_class=complexity_class,
                            ground_truth=ground_truth, overwrite=overwrite)

    def decorate(fn: Callable) -> Callable:
        reg.register(domain, logic, tiers={tier: fn},
                     complexity_class=complexity_class,
                     ground_truth=ground_truth, overwrite=overwrite)
        return fn

    return decorate
