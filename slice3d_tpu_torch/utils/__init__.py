"""Host-side helpers of the generation route's CLIs: slice montages and the
YAML config reader."""
