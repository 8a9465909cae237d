"""Native raw-volume loader (C, built at first use)."""
