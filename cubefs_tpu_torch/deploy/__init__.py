"""The port's cluster launcher (``deploy/cluster.py``)."""
