"""GAME model containers and the entity vocabulary."""
