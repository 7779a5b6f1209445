"""ControlPolicy: the declarative knob surface of the interval controller.

A frozen dataclass of the §III-B/C controller knobs plus a small registry of
named presets: the simulator's "sim-rainbow" and Layer B's "serving-default".
The HSCC and Nomad presets come with the policies that use them (ROADMAP.md
Queue 1 items 6 and 9).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

#: Counting backends of engine.control.observe_tiers: "kernel" is the fused
#: one-pass counter (kernels/page_counter), "scatter" the saturating
#: scatter-adds (the reference's "jax" backend).  The two are bitwise equal.
COUNTER_BACKENDS = ("kernel", "scatter")


@dataclasses.dataclass(frozen=True)
class ControlPolicy:
    """Interval-controller knobs, layer-agnostic.

    interval_steps   observe batches per monitoring interval (Layer B decode
                     steps; Layer A closes every chunk, i.e. 1)
    top_n            stage-2 monitor rows (hot superpages / superblocks)
    max_promotions   per-interval migration-plan size K (fixed shapes)
    hot_slots        performance-tier capacity in pages (DRAM slots)
    write_weight     stage-1 weighting of NVM writes vs reads (§III-B)
    threshold_init   initial adaptive admission threshold (§III-C)
    counter_backend  "kernel" (fused counting kernel) or "scatter"

    The reference's other knobs (counter_decay, async_window, abort_on_write,
    shadow_residency) come with the slices that use them (ROADMAP.md Queue 1
    item 9); every preset ported so far leaves them at their defaults.
    """

    interval_steps: int = 8
    top_n: int = 16
    max_promotions: int = 64
    hot_slots: int = 256
    write_weight: int = 2
    threshold_init: float = 0.0
    counter_backend: str = "kernel"

    def validate(self, context: str = "ControlPolicy") -> "ControlPolicy":
        """Reject impossible knob settings with a clear error, returning self."""
        if self.interval_steps < 1:
            raise ValueError(
                f"{context}: interval_steps must be >= 1 (got {self.interval_steps})"
            )
        if self.top_n < 1:
            raise ValueError(f"{context}: top_n must be >= 1 (got {self.top_n})")
        if self.max_promotions < 1:
            raise ValueError(
                f"{context}: max_promotions must be >= 1 (got {self.max_promotions})"
            )
        if self.hot_slots < 1:
            raise ValueError(f"{context}: hot_slots must be >= 1 (got {self.hot_slots})")
        if self.write_weight < 1:
            raise ValueError(
                f"{context}: write_weight must be >= 1 (got {self.write_weight})"
            )
        if self.counter_backend not in COUNTER_BACKENDS:
            raise ValueError(
                f"{context}: unknown counter_backend {self.counter_backend!r}; "
                f"expected one of {COUNTER_BACKENDS}"
            )
        return self

    def replace(self, **overrides: Any) -> "ControlPolicy":
        """dataclasses.replace + validate."""
        return dataclasses.replace(self, **overrides).validate()

    def control_config(self, num_units: int, pages_per_unit: int):
        """The engine-internal ControlConfig for one controller instance."""
        from repro_torch.engine.control import ControlConfig

        return ControlConfig(
            num_units=num_units,
            pages_per_unit=pages_per_unit,
            top_n=self.top_n,
            max_moves=self.max_promotions,
            write_weight=self.write_weight,
            counter_backend=self.counter_backend,
        )


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

PolicyFactory = Callable[..., ControlPolicy]
_REGISTRY: dict[str, PolicyFactory] = {}


def register_policy(name: str) -> Callable[[PolicyFactory], PolicyFactory]:
    """Register a named ControlPolicy factory (decorator)."""

    def deco(fn: PolicyFactory) -> PolicyFactory:
        if name in _REGISTRY:
            raise ValueError(f"policy {name!r} is already registered")
        _REGISTRY[name] = fn
        return fn

    return deco


def get_policy(name: str, **kwargs: Any) -> ControlPolicy:
    """Resolve a registered preset to a validated ControlPolicy."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown policy preset {name!r}; registered: {available_policies()}"
        ) from None
    return factory(**kwargs).validate()


def available_policies() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


@register_policy("serving-default")
def _serving_default(**_: Any) -> ControlPolicy:
    """Layer B defaults (the reference's ControlPolicy field defaults)."""
    return ControlPolicy()


@register_policy("sim-rainbow")
def _sim_rainbow(mc=None) -> ControlPolicy:
    """Paper §IV-F simulator parameters, read off a MachineConfig.

    Layer A closes the controller once per trace chunk -> interval_steps = 1.
    """
    if mc is None:
        from repro_torch.sim.config import MachineConfig

        mc = MachineConfig()
    return ControlPolicy(
        interval_steps=1,
        top_n=mc.top_n,
        max_promotions=512,
        hot_slots=mc.dram_pages,
        write_weight=mc.write_weight,
        threshold_init=mc.mig_threshold,
    )


#: Simulator policy -> registry preset.  Only rainbow is ported in this slice.
SIM_POLICY_PRESETS = {"rainbow": "sim-rainbow"}

#: The reference's other simulator policies -> the ROADMAP.md Queue 1 item
#: that ports them.
UNPORTED_POLICIES = {
    "flat-static": 6, "hscc-4kb-mig": 6, "hscc-2mb-mig": 6, "dram-only": 6,
    "nomad": 9,
}


def require_ported(policy: str) -> None:
    """Raise NotImplementedError for a simulator policy this slice lacks."""
    if policy in SIM_POLICY_PRESETS:
        return
    if policy in UNPORTED_POLICIES:
        raise NotImplementedError(
            f"policy {policy!r} is not ported yet "
            f"(ROADMAP.md Queue 1 item {UNPORTED_POLICIES[policy]})"
        )
    raise KeyError(
        f"unknown policy {policy!r}; expected one of "
        f"{sorted(SIM_POLICY_PRESETS) + sorted(UNPORTED_POLICIES)}"
    )


def sim_policy_for(policy: str, mc, counter_backend: str | None = None) -> ControlPolicy:
    """The effective ControlPolicy of one simulator cell: the policy's machine
    preset, with `counter_backend` when one is given."""
    require_ported(policy)
    pol = get_policy(SIM_POLICY_PRESETS[policy], mc=mc)
    if counter_backend is not None and counter_backend != pol.counter_backend:
        pol = dataclasses.replace(pol, counter_backend=counter_backend)
    return pol.validate()
