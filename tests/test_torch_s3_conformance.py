"""Every scenario of the reference's independent-client S3 suite,
``tests/conformance/test_s3_conformance.py``, on the port's gateway
(``port_copy``), none skipped. Its client (``tests/conformance/
s3client.py``) signs every request with its own SigV4 and shares no code
with either package; its ``stack`` and ``cli`` fixtures keep their module
scope here, and its scenarios their order in the file (the object-lock
scenario needs the bucket that the versioning one left versioned).
Tolerance: exact bytes.
"""

import importlib.util
import os

import pytest

from test_torch_fs import _port_qos_still  # noqa: F401  (autouse fixture)
from test_torch_raft import TESTS, port_copy, run_scenario


def _s3client():
    path = os.path.join(TESTS, "conformance", "s3client.py")
    spec = importlib.util.spec_from_file_location("s3client_for_the_port", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CONF = port_copy("conformance/test_s3_conformance", S3Client=_s3client().S3Client)
stack, cli = CONF.stack, CONF.cli  # mounted: one stack for the module, as in the suite


@pytest.mark.parametrize("name", [n for n in vars(CONF) if n.startswith("test_")])
def test_reference_s3_conformance_scenario_on_the_port(name, request):
    run_scenario(CONF, name, request)
