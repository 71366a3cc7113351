"""Dynamic data scheduling (paper §V-B): the E(D) sizing model."""
