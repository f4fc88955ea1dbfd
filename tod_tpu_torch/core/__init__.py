"""Configuration, wire types, device selection and weight loading."""
