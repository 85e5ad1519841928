"""Entry points beside the classifier: the gather-cost bench and its K3 kernel."""
