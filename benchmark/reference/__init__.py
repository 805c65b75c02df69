"""Plain NumPy references: they import neither JAX nor any windflow
package, and take nothing that the program computed."""
