"""Step drivers: what one step of a traffic mix does (see
``traffic/<name>.json``'s ``step``)."""
