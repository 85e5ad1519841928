"""Entry points beside the classifier: the gather-cost bench with its K3
kernel, the primitive benches and the capability probes."""
