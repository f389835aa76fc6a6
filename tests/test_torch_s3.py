"""The port's S3 gateway (``cubefs_tpu_torch/fs/objectnode.py`` with
``s3policy``, ``authnode``, ``s3auth``, ``s3ext``, ``s3version`` and
``s3audit``) held against the reference's on the CPU: every scenario of
the reference's ``test_gateways``, ``test_auth`` and
``test_s3_versioning`` runs on the port (``port_copy``), none skipped but
two of ``test_gateways`` that need modules of later slices:
``test_launcher_and_cli_end_to_end`` (``cli.py``, ROADMAP.md §1 item 5)
and ``test_fuse_chmod_and_rename_clobber`` (``fs/fuse.py``, §1 item 4.1).
``test_torch_s3_authz.py`` and ``test_torch_s3_conformance.py`` run the
other two suites. Tolerance: exact bytes.
"""

import pytest

from test_torch_fs import _port_qos_still, run_in  # noqa: F401  (autouse fixture)
from test_torch_raft import port_copy, scenarios

LATER = {"test_launcher_and_cli_end_to_end", "test_fuse_chmod_and_rename_clobber"}

GATEWAYS = port_copy("test_gateways")
MODULES = {
    "test_gateways": GATEWAYS,
    "test_auth": port_copy("test_auth"),
    "test_s3_versioning": port_copy("test_s3_versioning", _req=GATEWAYS._req,
                                    fscluster=GATEWAYS.fscluster),
}
CASES = [(m, n) for m, mod in MODULES.items() for n in scenarios(mod) if n not in LATER]


@pytest.mark.parametrize("module,name", CASES)
def test_reference_s3_scenario_on_the_port(module, name, request):
    run_in(MODULES[module], name, request)


def test_every_scenario_runs_but_the_two_of_later_slices():
    assert len(CASES) == 12 + 7 + 15
    assert LATER <= set(scenarios(GATEWAYS))
