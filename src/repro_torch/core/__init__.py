"""The device-tier index, its StorageEngine and the state exchange."""
