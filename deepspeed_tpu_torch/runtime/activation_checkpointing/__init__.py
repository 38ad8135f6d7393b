"""Activation checkpointing (rematerialization) of the port."""
