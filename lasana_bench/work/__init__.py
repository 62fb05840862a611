"""The yardstick's frozen operation and byte counts."""
