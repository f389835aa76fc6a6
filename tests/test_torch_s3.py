"""The port's S3 gateway (``cubefs_tpu_torch/fs/objectnode.py`` with
``s3policy``, ``authnode``, ``s3auth``, ``s3ext``, ``s3version`` and
``s3audit``) held against the reference's on the CPU: every scenario of
the reference's ``test_gateways``, ``test_auth`` and
``test_s3_versioning`` runs on the port (``port_copy``), none skipped;
``test_gateways``' ``test_launcher_and_cli_end_to_end`` (the CLI's) runs in
``tests/test_torch_operators.py``.
``test_fuse_chmod_and_rename_clobber`` mounts the port's volume through
the kernel under ``test_torch_fuse.fuse_guard``, which detaches a mount
that outlives its deadline.
``test_torch_s3_authz.py`` and ``test_torch_s3_conformance.py`` run the
other two suites. Tolerance: exact bytes.
"""

import pytest

from test_torch_fs import FS_E2E, _port_qos_still, run_in  # noqa: F401  (autouse fixture)
from test_torch_fuse import fuse_guard
from test_torch_raft import port_copy, scenarios

LATER = {"test_launcher_and_cli_end_to_end"}  # run by tests/test_torch_operators.py

GATEWAYS = port_copy("test_gateways", FsCluster=FS_E2E.FsCluster)
MODULES = {
    "test_gateways": GATEWAYS,
    "test_auth": port_copy("test_auth"),
    "test_s3_versioning": port_copy("test_s3_versioning", _req=GATEWAYS._req,
                                    fscluster=GATEWAYS.fscluster),
}
CASES = [(m, n) for m, mod in MODULES.items() for n in scenarios(mod) if n not in LATER]


@pytest.mark.parametrize("module,name", CASES)
def test_reference_s3_scenario_on_the_port(module, name, request, tmp_path):
    if "fuse" not in name:
        return run_in(MODULES[module], name, request)
    with fuse_guard(tmp_path):
        run_in(MODULES[module], name, request)


def test_every_scenario_runs_but_the_two_of_later_slices():
    assert len(CASES) == 13 + 7 + 15
    assert LATER <= set(scenarios(GATEWAYS))
