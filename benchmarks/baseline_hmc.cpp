// CPU baseline: sequential single-chain HMC on 100-d Bayesian logistic
// regression, structured like MCMCLib's hmc_impl (reference src/hmc.cpp:
// per-draw momentum refresh, n_leap_steps leapfrog steps, MH accept with
// min(0.01, .) clamp) with a hand-rolled dense gradient in place of
// Armadillo/Eigen (not installable here). Compiled -O3 -march=native —
// the reference's own optimization flags (reference configure:26,196-202).
//
// Prints: leapfrog steps per second (one number).

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <chrono>
#include <random>
#include <string>
#include <vector>

static const int D = 100;
static const int N = 1000;
static const int LEAP = 4;

struct Model {
    std::vector<double> X;  // N x D row-major
    std::vector<double> y;
    double prior_var = 100.0;

    void grad_and_logp(const std::vector<double>& beta, std::vector<double>& g,
                       double* logp) const {
        // logits = X beta; g = X^T (y - sigmoid(logits)) - beta / prior_var
        double lp = 0.0;
        for (int j = 0; j < D; ++j) g[j] = -beta[j] / prior_var;
        for (int i = 0; i < N; ++i) {
            const double* row = &X[(size_t)i * D];
            double z = 0.0;
            for (int j = 0; j < D; ++j) z += row[j] * beta[j];
            const double s = 1.0 / (1.0 + std::exp(-z));
            lp += y[i] * z - (z > 30 ? z : std::log1p(std::exp(z)));
            const double r = y[i] - s;
            for (int j = 0; j < D; ++j) g[j] += r * row[j];
        }
        for (int j = 0; j < D; ++j) lp -= 0.5 * beta[j] * beta[j] / prior_var;
        *logp = lp;
    }
};

// Cross-validation mode: `baseline_hmc --fit data.bin n_keep` reads
// (n, d, X row-major, y) as float64, runs the same sequential HMC with
// burn-in, and prints the posterior mean — an independent C++ check of
// the Python/JAX samplers on identical data.

static int run_fit(const char* path, long n_keep);

int main(int argc, char** argv) {
    if (argc > 2 && std::string(argv[1]) == "--fit") {
        return run_fit(argv[2], argc > 3 ? std::atol(argv[3]) : 8000);
    }
    double seconds = argc > 1 ? std::atof(argv[1]) : 3.0;

    std::mt19937_64 eng(42);
    std::normal_distribution<double> rnorm;
    std::uniform_real_distribution<double> runif;

    Model m;
    m.X.resize((size_t)N * D);
    m.y.resize(N);
    std::vector<double> beta_true(D);
    for (int j = 0; j < D; ++j) beta_true[j] = rnorm(eng);
    const double scale = 1.0 / std::sqrt((double)D);
    for (int i = 0; i < N; ++i) {
        double z = 0.0;
        for (int j = 0; j < D; ++j) {
            m.X[(size_t)i * D + j] = rnorm(eng) * scale;
            z += m.X[(size_t)i * D + j] * beta_true[j];
        }
        m.y[i] = runif(eng) < 1.0 / (1.0 + std::exp(-z)) ? 1.0 : 0.0;
    }

    std::vector<double> pos(D, 0.0), mom(D), g(D), new_pos(D);
    double logp, prev_U;
    m.grad_and_logp(pos, g, &logp);
    prev_U = -logp;

    const double eps = 0.01;
    long long leapfrogs = 0;
    auto t0 = std::chrono::steady_clock::now();
    double elapsed = 0.0;

    while (elapsed < seconds) {
        for (int it = 0; it < 20; ++it) {
            double prev_K = 0.0;
            for (int j = 0; j < D; ++j) { mom[j] = rnorm(eng); prev_K += 0.5 * mom[j] * mom[j]; }
            new_pos = pos;
            m.grad_and_logp(new_pos, g, &logp);
            for (int k = 0; k < LEAP; ++k) {
                for (int j = 0; j < D; ++j) mom[j] += 0.5 * eps * g[j];
                for (int j = 0; j < D; ++j) new_pos[j] += eps * mom[j];
                m.grad_and_logp(new_pos, g, &logp);
                for (int j = 0; j < D; ++j) mom[j] += 0.5 * eps * g[j];
                ++leapfrogs;
            }
            double prop_U = -logp, prop_K = 0.0;
            for (int j = 0; j < D; ++j) prop_K += 0.5 * mom[j] * mom[j];
            double comp = -(prop_U + prop_K) + (prev_U + prev_K);
            if (comp > 0.01) comp = 0.01;
            if (runif(eng) < std::exp(comp)) { pos = new_pos; prev_U = prop_U; }
        }
        elapsed = std::chrono::duration<double>(
            std::chrono::steady_clock::now() - t0).count();
    }
    std::printf("%.1f\n", (double)leapfrogs / elapsed);
    return 0;
}


namespace {

struct DynModel {
    int n = 0, d = 0;
    std::vector<double> X, y;
    double prior_var = 100.0;

    void grad_and_logp(const std::vector<double>& beta, std::vector<double>& g,
                       double* logp) const {
        double lp = 0.0;
        for (int j = 0; j < d; ++j) g[j] = -beta[j] / prior_var;
        for (int i = 0; i < n; ++i) {
            const double* row = &X[(size_t)i * d];
            double z = 0.0;
            for (int j = 0; j < d; ++j) z += row[j] * beta[j];
            const double s = 1.0 / (1.0 + std::exp(-z));
            lp += y[i] * z - (z > 30 ? z : std::log1p(std::exp(z)));
            const double r = y[i] - s;
            for (int j = 0; j < d; ++j) g[j] += r * row[j];
        }
        for (int j = 0; j < d; ++j) lp -= 0.5 * beta[j] * beta[j] / prior_var;
        *logp = lp;
    }
};

}  // namespace

static int run_fit(const char* path, long n_keep) {
    std::FILE* f = std::fopen(path, "rb");
    if (!f) { std::fprintf(stderr, "cannot open %s\n", path); return 1; }
    double hdr[2];
    if (std::fread(hdr, sizeof(double), 2, f) != 2) return 1;
    DynModel m;
    m.n = (int)hdr[0];
    m.d = (int)hdr[1];
    m.X.resize((size_t)m.n * m.d);
    m.y.resize(m.n);
    if (std::fread(m.X.data(), sizeof(double), m.X.size(), f) != m.X.size()) return 1;
    if (std::fread(m.y.data(), sizeof(double), m.y.size(), f) != (size_t)m.n) return 1;
    std::fclose(f);

    std::mt19937_64 eng(7);
    std::normal_distribution<double> rnorm;
    std::uniform_real_distribution<double> runif;

    const int d = m.d;
    const double eps = 0.05;
    const int LEAPS = 8;
    const long burnin = 2000;

    std::vector<double> pos(d, 0.0), mom(d), g(d), new_pos(d), mean(d, 0.0);
    double logp, prev_U;
    m.grad_and_logp(pos, g, &logp);
    prev_U = -logp;

    for (long it = 0; it < burnin + n_keep; ++it) {
        double prev_K = 0.0;
        for (int j = 0; j < d; ++j) { mom[j] = rnorm(eng); prev_K += 0.5 * mom[j] * mom[j]; }
        new_pos = pos;
        m.grad_and_logp(new_pos, g, &logp);
        for (int k = 0; k < LEAPS; ++k) {
            for (int j = 0; j < d; ++j) mom[j] += 0.5 * eps * g[j];
            for (int j = 0; j < d; ++j) new_pos[j] += eps * mom[j];
            m.grad_and_logp(new_pos, g, &logp);
            for (int j = 0; j < d; ++j) mom[j] += 0.5 * eps * g[j];
        }
        double prop_U = -logp, prop_K = 0.0;
        for (int j = 0; j < d; ++j) prop_K += 0.5 * mom[j] * mom[j];
        double comp = -(prop_U + prop_K) + (prev_U + prev_K);
        if (comp > 0.01) comp = 0.01;
        if (runif(eng) < std::exp(comp)) { pos = new_pos; prev_U = prop_U; }
        if (it >= burnin) {
            for (int j = 0; j < d; ++j) mean[j] += pos[j];
        }
    }
    for (int j = 0; j < d; ++j) std::printf("%.6f ", mean[j] / n_keep);
    std::printf("\n");
    return 0;
}
