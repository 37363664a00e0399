"""Platform selection from the environment (counterpart of
``plantcaduceus_tpu.utils.platform``).

``PCAD_PLATFORM=cpu`` runs any of the port's entry points on the host CPU
when no device flag is given; ``cuda`` (or ``gpu``) picks the card, which
is also the default without the variable. A device flag on the command line
wins over the variable. Any other value (``tpu``, say) is refused with a
``ValueError`` that names it: the port has no such platform, and a run on
another device than the one asked for would be a silent fallback. Each CLI
calls :func:`maybe_force_platform` first thing, where the JAX CLIs call
theirs, and takes :func:`default_device` as its device flag's default.
"""

from __future__ import annotations

import os
from typing import Optional

ENV = "PCAD_PLATFORM"
_DEVICES = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}


def maybe_force_platform() -> Optional[str]:
    """The device ``PCAD_PLATFORM`` asks for (``"cpu"`` or ``"cuda"``), or
    None when it is unset or empty; raises ``ValueError`` for any other
    value."""
    plat = os.environ.get(ENV, "")
    if not plat:
        return None
    dev = _DEVICES.get(plat.strip().lower())
    if dev is None:
        raise ValueError(f"{ENV}={plat!r}: the PyTorch port runs on 'cpu' or 'cuda' "
                         "(also spelt 'gpu'); unset it to run on the card")
    return dev


def default_device() -> str:
    """The entry points' default device: ``PCAD_PLATFORM``'s, else the card."""
    return maybe_force_platform() or "cuda"
