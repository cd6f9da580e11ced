"""``repro_torch.tune`` — the planner of the port: analytic cost model,
measured autotuner, persistent plan cache (port of ``repro.tune``).

    from repro_torch import tune
    p = tune.plan(op="ata", m=8192, n=8192, out="packed")   # analytic or cached
    p = tune.plan(op="ata", m=8192, n=8192, autotune=True)  # measured, persisted
    c = ata(a, plan=p)                                       # or just ata(a)

Every ``ata``, ``ata_batched``, ``strassen_tn`` and ``lstsq`` call that
pins no algorithm tunable (``n_base``/``variant``, or ``method`` for
``lstsq``) resolves through :func:`plan`; a pinned call takes the static
defaults of :mod:`repro_torch.tune.defaults` and is bitwise reproducible.

Modules: ``defaults`` (the tunable constants), ``cost`` (the cost model,
its machines and the frozen ``Plan``), ``search`` (autotuner and timing
discipline), ``cache`` (the plan store and ``plan()``), ``apply`` (plan →
base engines and callables).

This ``__init__`` is lazy (PEP 562): ``core`` and ``kernels`` import
``repro_torch.tune.defaults`` when they load, which must not load
``cost``/``cache``, since those import ``core`` back.
"""

from repro_torch.tune import defaults  # imports nothing: safe to load eagerly

__all__ = [
    "plan",
    "warm",
    "Plan",
    "autotune",
    "analytic_plan",
    "default_plan",
    "candidates",
    "defaults",
    "cost",
    "search",
    "cache",
    "apply",
]

_LAZY = {
    "plan": ("repro_torch.tune.cache", "plan"),
    "warm": ("repro_torch.tune.cache", "warm"),
    "Plan": ("repro_torch.tune.cost", "Plan"),
    "autotune": ("repro_torch.tune.search", "autotune"),
    "analytic_plan": ("repro_torch.tune.cost", "analytic_plan"),
    "default_plan": ("repro_torch.tune.cost", "default_plan"),
    "candidates": ("repro_torch.tune.cost", "candidates"),
    "cost": ("repro_torch.tune.cost", None),
    "search": ("repro_torch.tune.search", None),
    "cache": ("repro_torch.tune.cache", None),
    "apply": ("repro_torch.tune.apply", None),
}


def __getattr__(name):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module 'repro_torch.tune' has no attribute {name!r}")
    import importlib

    mod = importlib.import_module(mod_name)
    value = mod if attr is None else getattr(mod, attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
