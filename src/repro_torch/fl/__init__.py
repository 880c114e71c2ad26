"""The federated runtime (``run_federated``)."""
