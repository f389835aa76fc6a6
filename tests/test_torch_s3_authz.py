"""Every scenario of the reference's ``tests/test_s3_authz.py`` on the
port's S3 gateway (``port_copy``), none skipped: bucket policy, ACLs,
presigned URLs, SigV2, tagging, CORS, lifecycle configs read by the
port's ``LcNode``, aws-chunked streaming, POST policy, STS and both audit
sinks (the queue sink on the port's ``blob/mq.MessageQueue``).
Tolerance: exact bytes.
"""

import pytest

from test_torch_fs import _port_qos_still, run_in  # noqa: F401  (autouse fixture)
from test_torch_raft import port_copy, scenarios

AUTHZ = port_copy("test_s3_authz")


@pytest.mark.parametrize("name", scenarios(AUTHZ))
def test_reference_s3_authz_scenario_on_the_port(name, request):
    run_in(AUTHZ, name, request)
