"""Process groups and sharding for data-parallel (and data x model) runs."""
