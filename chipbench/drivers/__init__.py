"""Window loops, one per kind of traffic (`"driver"` in a traffic file)."""
