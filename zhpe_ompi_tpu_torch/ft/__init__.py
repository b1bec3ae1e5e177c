"""Fault tolerance — checkpoint/restart lineage + live-failure mitigation
(namesake: ``zhpe_ompi_tpu/ft``; the port's own copy).

The reference (Open MPI 5.0.0a1 vintage) carries three cooperating FT
mechanisms, all re-designed here for the host plane:

- ``ompi/mca/vprotocol/pessimist`` + ``pml/v`` — pessimistic message
  logging wrapped around the PML: :mod:`.vprotocol` interposes on the
  rank context the same way (sender-based payload logging + receiver event
  logging) and can deterministically replay a single restarted rank.
- ``ompi/mca/crcp/bkmrk`` — bookmark message counting so a checkpoint can
  prove the channels are quiescent: :mod:`.crcp`.
- ``opal/mca/crs`` single-process snapshots — the device-plane equivalent
  is :mod:`zhpe_ompi_tpu_torch.runtime.checkpoint`'s async tensor
  snapshots (message logging does not transfer to the device plane, where
  a step is a deterministic function and "replay" is just re-running it).

Plus the *live* failure path the fork was landing as ULFM:

- :mod:`.ulfm` — ring heartbeat failure detector, ``PROC_FAILED``
  classification, revoke/shrink/agree, failure ack.
- :mod:`.inject` — deterministic fault injection (kill rank r at op k,
  wedge rank r's device at step k) so every recovery path is testable on
  the CPU.
- :mod:`.recovery` — the shrink → rollback → respawn pipeline.

Submodule attributes resolve lazily (PEP 562): :mod:`.vprotocol` and
:mod:`.crcp` import the pt2pt layer, which itself needs :mod:`.ulfm` —
eager imports here would close that cycle.
"""

_LAZY = {
    "BookmarkCoordinator": ("crcp", "BookmarkCoordinator"),
    "UniverseLogger": ("vprotocol", "UniverseLogger"),
    "ProcessLogger": ("vprotocol", "ProcessLogger"),
    "RejoinContext": ("vprotocol", "RejoinContext"),
    "FailureState": ("ulfm", "FailureState"),
    "RingDetector": ("ulfm", "RingDetector"),
    "ShrunkEndpoint": ("ulfm", "ShrunkEndpoint"),
    "RankKilled": ("ulfm", "RankKilled"),
    "agree": ("ulfm", "agree"),
    "agree_failed_set": ("ulfm", "agree_failed_set"),
    "FaultPlan": ("inject", "FaultPlan"),
    "InjectedContext": ("inject", "InjectedContext"),
    "replay_rejoin": ("inject", "replay_rejoin"),
    "RespawnHandle": ("recovery", "RespawnHandle"),
    "respawn_rank": ("recovery", "respawn_rank"),
    "spawn_replacement": ("recovery", "spawn_replacement"),
    "await_rejoin": ("recovery", "await_rejoin"),
    "rollback": ("recovery", "rollback"),
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    try:
        modname, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(f".{modname}", __name__), attr)
    globals()[name] = value  # cache: resolve once
    return value
