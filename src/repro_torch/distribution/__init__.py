"""Distribution layer: logical-axis sharding rules, collectives, compression."""
