"""Logging and timing helpers of the port."""
