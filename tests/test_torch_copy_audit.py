"""Each host module the port copies differs from its JAX-package original
only by the package rename, plus the edits declared (by reference line
span, with the reason) in accord_tpu_torch/tools/copy_host.py: the places
where the reference reaches JAX or a device plane not ported yet."""
from __future__ import annotations

import pytest

from accord_tpu_torch.tools import copy_host


@pytest.mark.parametrize("rel", copy_host.HOST_MODULES)
def test_copy_differs_only_by_rename_and_declared_edits(rel):
    ok, desc = copy_host.audit_module(rel)
    assert ok, f"{rel}: {desc}"


def test_every_declared_edit_is_present():
    for rel in copy_host.EDITED:
        ok, desc = copy_host.audit_module(rel)
        assert ok and desc.startswith("edited"), f"{rel}: {desc}"
