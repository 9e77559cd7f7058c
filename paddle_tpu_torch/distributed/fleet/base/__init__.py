"""fleet.base: the strategy, the topology and the role maker."""
