"""Networks, layer configurations, weight init and precision policy."""
