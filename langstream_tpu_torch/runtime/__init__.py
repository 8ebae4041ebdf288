"""L3 of the port — the agent runtime (data plane): the poll→process→write
loop with ordered at-least-once commit, error routing, composite agents and
the in-process local application runner (``runner.py``, ``local_runner.py``,
the JAX package's ``runtime``), and the replica's runtime HTTP server
(``http_server.py``: the fleet routes, ``/metrics`` and ``/info``)."""
