"""The traffic generators a mix names."""
