"""Model and data I/O: Avro codec, index maps, cold store, GAME model files."""
